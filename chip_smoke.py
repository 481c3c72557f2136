"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

What it does, in order (any failure raises and exits non-zero):

1. Requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them.
2. Builds the CUDA kernels of ``whisper_tpu_torch/csrc`` with nvcc
   (sm_90a; one nvcc per source, all started together) and prints the
   build time, each kernel's register use and, from the library's SASS,
   that B1 and the products of B2, B9a and B9b hold warpgroup products and
   tensor-map loads, B3, B8, B4, B6 and both B7 kernels bulk copies, B7-i8
   int8 mma.sync, that B5's two kernels are there, B10c's two kernels
   cp.async, ldmatrix and bf16 mma.sync, and
   of B10a's
   and B10b's kernels the LN-and-product kernel cp.async and fp64 mma.sync
   (DMMA), B10a's attention cp.async, B10b's bulk copies and the O product
   cp.async, ldmatrix and bf16 mma.sync.
3. Runs each kernel (B1-B10c, sixteen rows, and the sampled pick) against its plain PyTorch
   version on the card at the shapes its path gives it (whisper-base, batch
   bucket 16: B1-B4 at x5, B6 at x4, B8 at x7, B9a/B9b with the fused
   encoder block, B10c in the hybrid decode step, B7 with five queries a
   row as the speculative verify pass gives it at draft_k = 4, B10a and B10b
   in the fully fused decode step; B5 at the one-shot limit of 7,680
   frames, beside the composition of PyTorch calls around ``torch.stft``
   (cuFFT) that computes the same function; B2 and B9a also at
   whisper-medium's d=1024), and the sampled pick of a decode step at T > 0
   (``ops.sampling``, no Pallas counterpart: a Philox Gumbel-max draw keyed
   by the loop's state, each row split across the card) at bucket 16 over
   whisper-base's 51,865 ids, its ids, uniforms and scores bitwise the
   plain version's, one kernel a call, its device µs a call from a graph of
   128 picks at bucket 16 and 1, its bound the larger of its bytes and the
   issue of the instructions the function needs (``pick_work_ms``; the
   issue of its compiled loop, read from its SASS, printed beside), beside
   the composition ``exponential_`` ... ``argmax`` the loops ran before,
   prints the largest difference, the time of one call of each (median of
   five runs of 20 calls), the least time the card could take for the same work (the
   larger of its bytes over 3.35 TB/s and its operations over the peak rate
   for their type) and, where one PyTorch call computes the same function,
   that call's time.  B1 (wgmma, scores in registers) is also held at
   whisper-medium's bucket-1 shape (16 heads) and at T = 100, and prints a
   second bound, the 111 GFLOP its two-pass contract executes; B4 (a
   cluster of blocks a head) also at bucket 1 with 6 heads and at S = 1504
   with 1,500 valid columns, and its wrapper must put exactly one operation
   on the card a call (counted by torch.profiler); B6 (B4's cluster,
   dequantizing) at S = 96, 192, 193, 1500, 1504 (1,500 valid) and 2000
   (1,999 valid), at bucket 16 with 8 heads and at bucket 1 with 6, and it
   and B7-dq one operation a call; B4 and B6 also at the 64 rows of beam
   search at K = 4 (the cache tiled per beam, the scales as views), each
   beam's rows bitwise the call on the untiled cache.  B7 is also held, query by query and
   bitwise, against the single-token kernels B4 and B6 at T = 1, 2, 5, 9
   and 17 and S = 96, 193, 1500, 1504 and 2000, and timed at T = 5
   beside five calls of B4 or B6; B10c beside the bf16 composition of five
   PyTorch calls that computes it; what B10a writes into the cache bitwise
   against the plain version at pos 0, 70 and 131, with ``pos`` as an int
   and as a device tensor; B10b at T = 1500, 96, 100 and 1731 (a short last
   key block); two calls of each bitwise equal and at most three device
   operations a call.  B2 (LayerNorm
   and two tiled wgmma products) is also held at 1, 1,499 and 24,000 rows at
   d = 512 and at 1,500 rows at d = 1,024 and 1,280, must put exactly its
   three kernels on the card a call, and is printed beside the bf16
   composition of five PyTorch calls that computes the same function; B9a
   and B9b (B2's LayerNorm kernel and products under names of their own)
   at 1, 1,499 and 24,000 rows, B9a also at d = 1,280 and B9b at d = 128,
   384 and 768, two calls of each bitwise equal, two device operations a
   call for B9a and four for B9b, each beside the bf16 composition of
   PyTorch calls that computes it; B3
   (bulk copies of its cache rows) at pos 0, 70 and S - 1 with mixed pads,
   with ``pos`` as an int and as a device tensor (bitwise the same output and
   caches), one operation a call with and without ``pad_count``.  B8 the
   same at S = 131, 132 and 448, its four buffers bitwise the plain
   version's; B5 at 1, 16, 17, 3,000 and 7,680 valid frames in buckets of
   3,000 and 12,000, both wires, 80 and 128 mels (within 1e-4 of the plain
   version, or of its float64 evaluation where the plain version itself is
   farther from that), two calls bitwise equal and two device operations a
   call.  An empty
   kernel launched through the same C interface is timed and printed beside
   the kernels whose bound is under 20 microseconds.  The greedy step's
   tail (``ops.loop_tail``: the loop state's update after the pick and, in
   a while node's body, the node's condition, one kernel of
   ``csrc/graph_cond.cu``) bitwise its plain version at 1, 16, 64 and 1,025
   rows, step 0 and the last column, rows done before it, ending at it and
   going on, with and without scores, one kernel a call; the while node's
   condition kernel (C) held by the trips a node runs against its plain
   loop; both timed alone in ``[graph]`` (g).
4. Holds the port on the card against the port on the CPU (the kernels'
   plain versions) on a small input: an 80 s clip through the front end,
   the encoder and twelve teacher-forced decode steps.
5. Drives the main path, ``whisper_tpu_torch.headline``'s workload
   (whisper-base, random weights from seed 0, rung x5, the 301.574 s
   synthetic file; each decode one launch of a CUDA graph captured in the
   warm-up), once to warm up and then three timed times, with every
   kernel's launch count set to 0 just before each run and read just after;
   asserts the token shape, identical tokens across runs, finite encoder
   states and logits, and that every kernel of the path was launched, the
   greedy tail once a step and C ahead of the decode's while node.
5b. ``[wire]`` (``check_wire``): the main path's session in each of the
   seven upload wires of ``RuntimeCfg.audio_transfer`` (f32, int16,
   dint16, dint16p, ulaw8, pcm12, pcm14): (a) the 301.574 s file through
   the graphed long-form path, a warm-up and three timed runs each, its
   bytes shipped, host encode ms, upload ms and device decode µs printed,
   the card's decode of every slab bitwise the port's on the CPU, the
   main path's kernels launched and B5 not, the tokens against int16's:
   dint16 and dint16p bitwise (their mel too), every divergence of f32,
   ulaw8, pcm12 and pcm14 a tie-flip by ``divergence_report`` on each
   wire's own mel; (b) B5 one shot on a 76 s clip in each wire, launched
   once by the session's mel, its wrapper within 1e-4 of its plain version
   (or of its float64 evaluation where the plain version is farther) and
   timed; (c) a short-lane tick at bucket 16 under pcm12 and dint16, a key
   each, two graphed ticks bitwise the eager one, dint16's tokens int16's;
   (d) the CLI with ``--audio-transfer auto`` and ``auto-pcm``: the probe's
   rates and pick, and the run in that wire.
6. Drives the same file at whisper-base through the rest of the ladder
   and ``RuntimeCfg``, a warm-up and three timed runs each, counts set to 0
   just before each and read just after: rung x7 (B8 and B4 once per layer and
   step, no B3), rung x6 (the W8A8 encoder; kernels as at x5), and x5 with
   ``fused_encoder_block`` and ``fused_decoder_step`` (B9a, B1 and B9b once
   per encoder layer, B10c once per layer and step, none of B2, B3, B4).
   Prints e2e, model time and launches of each beside x5's (the fused
   block at whisper-small's and whisper-medium's widths: 8d).
7. Speculative decoding on the same file: x5 with a random whisper-tiny
   draft (draft_k = 4; B7 once per layer and verify round run, the rounds
   run by a graph's while node: the rounds counted), x5 with
   whisper-base as its own draft sharing the encoder (the accept path:
   about ceil(128 / 5) rounds), x4 with the tiny draft (B7's dequantizing
   kernel).  The two x5 runs must give the same tokens (one rejects nearly
   every proposal, the other accepts nearly all: the same arithmetic,
   opposite bookkeeping), each chunk's first token must be the greedy
   run's, and the share of tokens equal to the greedy run's is printed with
   rounds and tokens committed per round.
7b. The decoding options on the same file (``check_decoding``, ``[decoding]``
   lines): the timestamp grammar at x5 and x7, every row checked by a
   grammar checker, two runs equal; scores at T = 0, the tokens bitwise the
   main path's and each count the row's length to its first EOT; the
   fallback ladder 0, 0.2 ... 1.0 with every gate failing (every chunk walks
   every rung; 64 tokens), twice with one seed (equal at every rung) and
   once with another (different), no suppressed id drawn; beam search K = 1
   against greedy decoding on the step beam search takes (equal), and K = 4
   at x5 (B4 at 64 rows) and x4 (B6), with the share of tokens equal to
   greedy x5's.
7c. Conditioned prompts, the sequential mode, word timings and the judge
   (``check_prompts_words``, ``[prompts]`` lines): the same file's bucket of
   16 decoded at x5 (B3) and x7 (B8) with ``[<|startofprev|>] + tail``
   left-padded to 64 slots (three pad counts across rows) against each
   row's unpadded prompt, every first divergence judged by
   ``variants.diagnose.divergence_report`` (one that is not a tie-flip
   fails), B3 and B8 launched with a ``pad_count`` on every step; the
   sequential mode at x5 and x7 on a 76 s file, conditioned on the previous
   text with an initial prompt, twice (equal tokens); word timings at x5,
   chunked and sequential (alignment rows summing to 1 within 1e-3, words in
   order within each chunk and inside the file, the card's words within
   0.02 s of the CPU's at fp32); the judge on x7 against x5 and on
   speculative against greedy at x5 and x4 (printed, never failing); the CLI
   over the four files with ``--longform-mode sequential
   --condition-on-prev-text``, ``--word-timestamps --write-srt --write-vtt``
   (every cue file parses) and ``--vad-filter --word-timestamps``.
7d. Serving (``check_serve``, ``[serve]`` lines), whisper-base, 128 tokens:
   (a) the engine's short lane at x4 (the server's default) and x5, a
   burst of 16 synthetic clips of 1-30 s, each row against the clip alone
   through ``transcribe_short_batch`` at bucket 1 (equal, or every first
   divergence a tie-flip by ``divergence_report``), B1, B2, B3 and B6 (x4)
   or B4 (x5) launched and B5 not, four clips of 1-3.5 s trimmed and at
   full width (equal); (b) a 76 s file on the long lane while 16 clips are
   in flight (the shorts resolve first, its text is ``transcribe_longform``'s
   alone, the short lane's p95 with and without it); (c) 4 TCP clients x 4
   requests through ``serve.server`` and then through ``serve.router`` in
   front of it (the same answers, or tie-flips), ``{"stats": true}``;
   (d) the OpenAI HTTP API: json, srt, verbose_json with words, SSE,
   /healthz, /v1/models; (e) the speculative leg, whisper-base's own int8
   weights as draft (B7), against the greedy burst; (f) a lone 5 s request
   and ``serve_bench``'s 64 streams of 30 s, three times (aggregate x real
   time, p50, p95); then the card test of two threads launching B3 and B8
   across 48 KB at once, in a fresh process.
7e. The pipelined long-form mode and the last user tools
   (``check_pipelined``, ``[pipelined]`` lines), whisper-base, 128 tokens:
   (a) the same file at x5 through ``transcribe_longform_pipelined`` at
   ``slab_chunks`` 4 and 16 (per-chunk mel normalization, slab by slab),
   B1, B2, B3 and B4 launched and B5 not, the rows of slab 4 against slab
   16's with every first divergence a tie-flip by ``divergence_report`` on
   the chunk-normalized windows; (b) ``chunk_norm_window`` on the card
   against numpy on the host (atol 1e-6), a ragged bucket's padding rows
   all zeros; (c) speculative over pipelined with the model's own int8
   weights as draft (B7), against greedy pipelined; (d) ``save_params`` /
   ``load_params`` of whisper-base value for value without the
   ``safetensors`` package, the CLI from that dir at x5 and from its
   ``quantize_model_dir`` copy at int8 (B6), each text the in-memory
   session's; (e) ``bench.discover`` over x4, x5 and x7 on 60 s, then the
   CLI with its JSON; (f) the CLI with ``--longform-mode pipelined`` over
   the four CLI files, plain and with ``--word-timestamps --language
   auto``, then ``results.summarize`` and ``results.accumulate`` over its
   output.
8. The fully fused decode step (``decoder_step_fused``: B10a, B10b, B10c per
   layer) for 127 steps from a bf16 prefill at bucket 16: the first step's
   logits within 5e-2 of ``decoder_step`` on the same cache, finite tokens
   equal across two runs, 127 x 6 launches of B10a and of B10b; the same
   127 steps replayed from one captured CUDA graph of a step (token and
   ``pos`` on the card), whose tokens must equal the eager loop's; the time
   per step of both beside the x5 kernel step's and the hybrid step's; then
   the 127 eager steps once more under torch.profiler: B10a's, B10b's and
   B10c's in-situ time a call, by kernel, and the device time a step.
8b. ``[graph]`` (``check_graph``): the greedy loop that every session runs
   on the card is one launch of a CUDA graph a decode (``runtime.generate``);
   here it is held against the same step function run eagerly
   (``session.eager_decode``): (a) the main path at x5, graphed and eager
   alternated, three runs each: tokens bitwise and launches equal, e2e and
   ms a decode step of both beside the fully fused step's replay; (b) the
   bucket of 16 at x3, x4, x5, x7, both fused flags, the grammar, a 68-slot
   left-padded prompt through B3 and B8, and sampling at T = 0.5 with a
   seed: tokens bitwise (the sampled draws too: the key is in the loop's
   state), every kernel's launches equal, one graph launch a call;
   (c) the host seconds until ``transcribe_from_mel_async`` returns beside
   those to queue the encoder alone and against the card's span of the
   work it queued, one graph launch a call, and the sequential mode's
   windows running a bucket-1 graph with the grammar and ``pad_count``;
   (d) capture seconds a key and the peak device memory of an x5 session,
   eager and graphed; (g) the while node's cost an iteration: a body of one
   counting kernel and C under the node for 128 trips against a flat graph
   of 128 launches of it; a body of the greedy tail setting the condition
   itself against the same tail followed by C and against the tail in a
   flat graph (what the node costs without C, what C costs in a body); C
   and the tail alone in flat graphs of 128 launches, beside an empty
   kernel.  In (b) every graphed
   greedy call launches C once (ahead of the node: the body ends in the
   tail) and prints an iteration's device operations.  The main path, the ladder, the decoding options,
   the prompts, serving and the pipelined mode above all run graphed.
   (e) beams K = 4 at x5 and x4 (64 beam rows, B4 or B6), graphed and
   eager alternated: tokens bitwise, launches equal, e2e and model_s; at
   x5 ms a beam step graphed and eager, and the grammar and left-padded
   prompts graphed against eager; (f) speculative rounds at x5 and x4 with
   a random whisper-tiny draft and with the model's own int8 weights as
   draft, graphed and eager alternated: tokens bitwise, rounds and
   launches equal, rounds counted and run, e2e; at x5 ms a round; each
   new key's capture seconds and kept state.  The eager loops of (b), (e)
   and (f) read ``done`` every step (round), where the graphed ones stop.
8c. ``[exit]`` (``check_exit``): every graphed greedy, beam and speculative
   decode is one launch of a graph whose step (round) is the body of a
   CUDA-graph while node on "trips < n and some row undone"
   (``runtime.generate._while_node``), so the card stops where
   ``lax.while_loop`` stops.  An end-of-text id that the 301.574 s file's
   chunks emit at steps of their own within 12, a bucket of 16 of those
   chunks and one of 1; against the eager loop reading ``done`` every
   step: (a) greedy, synchronous and ``_async``, tokens, sum_lp and n_tok
   bitwise, steps run the ``while_loop``'s trip count; (b) beams K = 4
   (only those chunks' first ids kept, so every beam ends); (c)
   speculative with a random whisper-tiny draft and with the model's own
   int8 weights; launches equal throughout; device ms of each decode
   beside the same call with no row ending (greedy and beams then run
   exactly n - first = 127 steps), and the host ms until each ``_async``
   form (``transcribe_short_speculative_async`` too) returns, one graph
   launch, beside the host ms to queue the encoder alone and the card's
   span of its work; with either draft the speculative dispatch must
   return within half its span.
8d. ``[medium]`` (``check_medium``): the medium family at full width (80
   mels, whisper-small: d = 768, 12 heads of 64, 12 + 12 layers;
   whisper-medium: d = 1,024, 16 heads, 24 + 24 layers; whisper-medium.en and
   distil-medium.en: vocab 51,864), depth uncut, random weights from seed 0
   (the draft's from seed 1) drawn once each, in turn, on one thread that runs
   from here on (``_draw_family_weights``).  First B1 (beside SDPA), B2c (the
   JAX rule's "chunked" MLP at both widths, beside the composition of five
   PyTorch calls), B9a at d = 768 and B9a' at 1,024 (beside their
   composition), B3 (its caches bitwise) and B4 (bitwise) at both, B6 at
   whisper-small and B7-i8 at whisper-medium.en's verify pass (16 rows, 16
   heads, five queries, each bitwise B4's), each against its plain version,
   timed, with its bound.  (a) whisper-small and (b) whisper-medium at x5 on
   the 301.574 s file (``_medium_file``): a warm-up and three timed runs,
   tokens equal and in the vocabulary, one graph launch a bucket, launches by
   the capture's tally, an eager run bitwise the graphed tokens with equal
   launches, finite encoder states and logits; capture seconds, the key's
   state and pools beside ``decode_footprint``'s caches and
   ``program_pool_bytes``, the peak above the part's start, in-situ µs from a
   traced eager run of 16 tokens; (c) on each session the card against the
   port on the CPU on one 30 s chunk (``MEDIUM_ENC_STEPS`` bf16 steps, logits
   5e-2); then the same file with ``fused_encoder_block``: the "chunked"
   composition the JAX rule picks at d >= 768 (B9a = B1 = B2 = the encoder's
   layers, no B9b), B9a's in-situ µs, every chunk that differs from the
   unfused tokens a judged tie-flip.  (d) whisper-medium.en with ids
   suppressed across its 51,864 ids (``_medium_en_speculative``): greedy
   graphed, then speculative, draft_k 4, on the shared encoder with a random
   distil-medium.en draft and with its own int8 weights, graphed: rounds
   counted = run, B7 = 24 x rounds, B4 = the draft's layers x 4 x rounds, the
   drafts' tokens bitwise equal, every divergence from greedy a judged
   tie-flip, the key's pools beside ``speculative_footprint`` and
   ``program_pool_bytes``; then the timestamp grammar and T = 0.5 on the
   bucket's encoder states, graphed twice and eagerly, bitwise, every row
   within the grammar.  (e) the CLI at whisper-small ``--variant int8`` over
   the 76 s WAV (B5, B6 at 12 heads, no B4) and at whisper-medium x5 over the
   4 s WAV (B2c), each on the weights drawn above (``_drawn_weights``).  A
   line gives each part's seconds.
8e. ``[large]`` (``check_large``), after ``[medium]``: the large
   family at full width (128 mels, d = 1,280, 20 heads of 64, vocab
   51,866), random weights from seed 0 built once each.  First B1, B2c,
   B3, B4 and B5 at the shapes whisper-large-v3-turbo's main path gives
   them (bucket 16, 4 decoder layers; B5 at 128 mels and 7,680 frames),
   each against its plain version, timed, with its bound.  (a)
   whisper-large-v3-turbo at x5 on the 301.574 s file (12 chunks in one
   bucket of 16, 128 tokens; ``headline.make_session("cuda", ..., "x5",
   "openai/whisper-large-v3-turbo")``): a warm-up and three timed runs,
   tokens equal and in the vocabulary, one graph launch a bucket, launches
   by the capture's tally (B1 = B2 = 32 a program launch, B3 = B4 = 4 a
   step run, the tail once a step, C once, B5 0), an eager run
   (``eager_decode``) bitwise the graphed tokens with equal launches,
   finite encoder states and logits; prints e2e (median of 3), x real
   time, model_s, capture seconds, the key's state, inputs and pools
   beside ``decode_footprint``'s caches and ``program_pool_bytes``, the
   peak device memory above the phase's start, and the kernels' in-situ
   µs from a traced eager run with five one-shot mels of 76.8 s (B5).
   (b), run first on the same session: the card against the port on the
   CPU at turbo, one 30 s chunk: the mel at 128 bins (1e-4), the encoder
   states after 32 layers (``LARGE_ENC_STEPS`` bf16 steps), the prefill's
   logits over 51,866 ids and four teacher-forced steps (5e-2).  (c)
   whisper-large-v3 (32 decoder layers) on the same file: one graphed and
   one eager run, tokens bitwise and launches equal, one graph launch;
   capture seconds, the body's nodes, ms a step graphed and eager, the
   key's state, inputs and pools against the gate's prediction, and
   whether ``check_fit`` passes at bucket 16 with that key's pools and the
   budget other keys may keep.  (d) the CLI at turbo (``--model-id
   openai/whisper-large-v3-turbo --allow-random-init --variant x5``) over
   the 76 s WAV (one-shot front end: B5 at 128 mels): per-file e2e, the
   Timing split, the peak above its start.  The kernel rows also hold
   SDPA beside B1 and the bf16 composition beside B2c at turbo's shapes,
   B7-i8 at large-v3's verify pass (16 rows, 20 heads, five queries) and
   B4 at its 32 beam rows.  (e) large-v3 on (c)'s session, speculative,
   draft_k 4, with a random distil-large-v3 draft (seed 1, drawn on the
   same thread after large-v3's weights) on its own encoder and on the
   shared one, and with large-v3's own int8 weights, an eager run bitwise
   the graphed one on the shared encoder (``_large_speculative``); (f) the
   same session with beam 2, timestamps and translate at large-v3's own
   special ids (``_large_beams``); (i) the CLI at large-v3 with
   ``--num-beams 2 --timestamps --task translate``, a tokenizer.json of
   large-v3's special ids and the weights (c) drew (``_large_cli``); (g)
   distil-large-v3 serving: the engine warmed at max_batch 16, a burst of
   16 clips against each alone, 32 streams of 30 s three times, no capture
   after the warm-up; (h) distil-large-v3 on the 301.574 s file
   (``_large_distil``).  A line gives each part's seconds.
9. Drives the benchmark CLI (``whisper_tpu_torch.bench.cli.main``, in
   process) over four synthetic WAV files (4 s; 29.5 s at 44.1 kHz stereo;
   76 s, just under the one-shot limit; 150 s, streamed) at whisper-base
   ``--variant x5`` and ``--variant int8``, every kernel's count set to 0
   just before each run and read just after; asserts rc 0, the reference's
   CSV header and summary keys, four rows of the files' durations, B5 on
   every one-shot mel, B4 and not B6 at x5, B6 and not B4 at int8; prints
   each run's per-file e2e, p95 and peak device memory.
   One more run at ``--variant x7`` over the four files (B8 and B4, no B3),
   one at x5 with each decoding flag (``--timestamps``, ``--language auto``,
   ``--temperatures 0,0.2,0.4``, ``--num-beams 4``; 32 tokens), and one at x5
   with ``--draft-model-id openai/whisper-tiny`` over the 4 s file (B7).
9b. ``[audio]`` (``check_audio``): the native decoder built from the
   checkout on this machine (g++ and libav's headers; where they are
   missing one line says why, and the run goes on: a host library, not the
   card); the 76 s clip written as a FLAC beside its WAV, both decoded
   sample-equal, both through the CLI at whisper-base x5 with equal texts.
9c. ``[parallel]`` (``check_parallel``), whisper-base, the 301.574 s file:
   (a) a world of one over NCCL through the mesh code path
   (``make_mesh(1, 1)``, ``shard_params``, the data rows, the row-parallel
   branches), graphed by the rule (``generate.graphed``): one graph launch
   a bucket, tokens bitwise and launches equal to the session's without a
   group and to the same world run eagerly, e2e of both; (a') an NCCL
   all-reduce on the world's group captured in a while node's body (the
   trial capture's nodes walked first): its trips and values bitwise an
   eager loop of the same steps, its device µs an iteration beside the
   same body without it; (b) two ranks sharing cuda:0 over gloo (``python3
   chip_smoke.py --parallel-rank R PORT REF OUT`` each, spawned with a
   timeout; a rank that exits non-zero fails the run): DP 2 at x5, each
   rank graphed (its model axis of one rank; the tokens' gather over gloo
   after the launch), one launch a bucket, its tokens bitwise its own
   eager run; TP 2 at x5 and at x7 (4 of 8 heads a rank), eager by the
   rule (the model axis over gloo), a line saying so; each rank's B1, B2,
   B3 or B8 and B4 launches counted, every chunk that differs from the
   one-process bucket-16 rows judged by ``divergence_report`` (a divergence
   that is not a tie-flip fails), e2e printed beside the one-process
   run's.
10. Prints one JSON line with the kernels (the tail's and C's launches:
   the main path's, 127 tails and one C a 128-token bucket), then, as the
   last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import gc
import itertools
import json
import os
import statistics
import sys
import tempfile
import time


def _median_ms(fn, runs: int = 5, calls: int = 20) -> float:
    """Time of one call of ``fn``: CUDA events around ``calls`` calls back
    to back, a synchronize after each run, the median over ``runs`` runs.
    A wrapper's host work (launches, its small torch ops) is inside it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# Published peaks of one H100 SXM (dense): device memory 3.35 TB/s; bf16
# 989 TFLOP/s and int8 1,979 TOP/s on the tensor cores; fp32 67 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _bound(n_bytes: float, n_ops: float, kind: str):
    """The least time (ms) the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the peak for their type;
    and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bf16_steps(got, want) -> float:
    """Largest |got - want| in bf16 spacings (2^-7 relative) of the larger
    magnitude, the mean magnitude of ``want`` as the floor near zero."""
    import torch

    got, want = got.float(), want.float()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          want.abs().mean())
    return float(((got - want).abs() / (scale * 2.0 ** -7)).max())


# Hopper's rates a clock on each SM, in thread instructions: its four
# schedulers issue one warp instruction each; integer arithmetic has 64
# lanes, the special-function unit (MUFU) and conversions 16, loads and
# stores 32.  The clock is the one at which fp32's 67 TFLOP/s peak holds
# (132 SMs x 128 lanes x 2 operations): 1.98 GHz.
SMS = 132
SM_LANES = {"issue": 128, "int": 64, "mufu": 16, "mem": 32}
SM_CLOCK = PEAK_OPS["fp32"] / (2 * 128 * SMS)
_INT_OPS = {"LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "SEL", "PRMT", "POPC",
            "FLO", "BREV", "BMSK", "SGXT", "VIADD", "VIMNMX"}
_MUFU_OPS = {"MUFU", "I2F", "F2I", "F2F", "I2I", "FRND", "I2FP", "F2IP"}
_MEM_OPS = {"LDG", "STG", "LD", "ST", "LDS", "STS", "ATOM", "ATOMG", "RED",
            "REDG"}


def _sass_class(op: str) -> str:
    """The pipe an instruction (its opcode) issues to beyond the
    scheduler: "int", "mufu", "mem" or "other" (fp32 and moves, at the
    issue rate)."""
    base = op.split(".")[0]
    if base in _MUFU_OPS:
        return "mufu"
    if base in _MEM_OPS:
        return "mem"
    if base in _INT_OPS or base.startswith("I"):
        return "int"
    return "other"


def pick_loop_counts(sass: str) -> dict:
    """The instructions of one group of four ids in the pick kernel as the
    decode launches it (no draws written), read from its SASS: the loop
    over groups is the backward branch that spans the most instructions;
    its body's Philox multiplies by 0xD2511F53 (ten a group) say how many
    groups one pass of it takes.  Returns {"issue", "int", "mufu", "mem"}
    a group, "groups_a_pass" and the body's "opcodes" by count."""
    import re

    part = next((p for p in sass.split("Function : ")[1:]
                 if "18gumbel_pick_kernelILb0E" in p.split("\n", 1)[0]),
                None)
    if part is None:
        raise AssertionError("the pick kernel (no draws) is not in the SASS")
    insts, labels, pending = [], {}, []
    for line in part.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            words = m.group(2).split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                insts.append((addr, words[0], m.group(2)))
    loops = []
    for addr, op, text in insts:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"\((\.L_x_\d+)\)", text)
        target = (labels.get(m.group(1)) if m else
                  int(re.search(r"0x([0-9a-f]+)", text).group(1), 16))
        if target is not None and target < addr:
            loops.append((target, addr))
    if not loops:
        raise AssertionError("the pick kernel's SASS has no loop")
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    # a forward branch over a call skips the division's slow path (a
    # divisor or quotient out of the fast path's range): not counted
    skipped = set()
    for addr, op, text in insts:
        if lo <= addr <= hi and op.split(".")[0] == "BRA":
            target = int(re.search(r"0x([0-9a-f]+)", text).group(1), 16)
            over = [a for a, o, _ in insts if addr < a < target]
            if addr < target <= hi and any(
                    o.startswith("CALL") for a, o, _ in insts
                    if addr < a < target):
                skipped.update(over)
    body = [(op, text) for addr, op, text in insts
            if lo <= addr <= hi and op != "NOP" and addr not in skipped]
    # each Philox round takes one product's high word by 0xD2511F53
    philox = sum(1 for op, text in body
                 if op in ("IMAD.HI.U32", "IMAD.WIDE.U32")
                 and re.search(r"0xd2511f53|-0x2daee0ad", text.lower()))
    per_pass = max(1, round(philox / 10))
    counts = {"issue": 0, "int": 0, "mufu": 0, "mem": 0}
    opcodes: dict = {}
    for op, _ in body:
        counts["issue"] += 1
        kind = _sass_class(op)
        if kind != "other":
            counts[kind] += 1
        opcodes[op] = opcodes.get(op, 0) + 1
    out = {k: v / per_pass for k, v in counts.items()}
    out.update(groups_a_pass=per_pass, philox_multiplies=philox,
               opcodes=dict(sorted(opcodes.items(), key=lambda kv: -kv[1])))
    return out


def issue_ms(counts: dict, n: int = 1) -> float:
    """The least time (ms) the card's SMs take to issue ``n`` times the
    thread instructions ``counts`` holds by pipe (the keys of
    ``SM_LANES``), each pipe at its rate."""
    clocks = max(counts.get(k, 0) / SM_LANES[k] for k in SM_LANES)
    return n * clocks / SMS / SM_CLOCK * 1e3


# The work the sampled pick's function needs, in thread instructions by
# pipe: what any kernel computing it must issue, not what the pick kernel
# spends (no moves, branches or loop control; Philox's round keys, the
# same for every group, made once).  A group of four ids: Philox4x32-10's
# ten rounds, each two 32 x 32 -> 64-bit products and two three-input
# xors.  An id whose logit is finite: the uniform (one shift-and-add, one
# subtraction), two precise logf on their normal-range path (libdevice's:
# three integer operations, one conversion, thirteen fp32), max(-log u,
# FLT_MIN), the division's fast path by the launch's reciprocal of T (a
# product and two fma), the subtraction, and the compare into the running
# best (an fp32 compare, a float and an integer select): 8 integer, 2
# conversions and 34 fp32.
PICK_GROUP_WORK = {"issue": 40, "int": 40}
PICK_ID_WORK = {"issue": 44, "int": 8, "mufu": 2}


def pick_work_ms(logits) -> float:
    """The least time (ms) the card takes to issue the sampled pick's work
    (``PICK_ID_WORK``, ``PICK_GROUP_WORK``) on these logits: Philox for
    each group of four ids that holds a finite logit, the draw and the
    compare for each finite logit (a -inf logit's score is -inf whatever
    its draw)."""
    import torch

    rows, vocab = logits.shape
    finite = torch.isfinite(logits)
    pad = torch.zeros(rows, -vocab % 4, dtype=torch.bool,
                      device=logits.device)
    groups = int(torch.cat([finite, pad], 1).view(rows, -1, 4).any(2).sum())
    ids = int(finite.sum())
    return issue_ms({k: groups * PICK_GROUP_WORK.get(k, 0)
                     + ids * PICK_ID_WORK.get(k, 0) for k in SM_LANES})


def check_sass(lib_path):
    """What the compiler made of the kernels built on Hopper's own
    instructions, read from the library with cuobjdump: the encoder
    attention kernel and the encoder MLP's products must hold warpgroup
    products (HGMMA) and tensor-map loads (UTMALDG), the self- and the
    cross-attention steps (B3, B8, B4, B6) and both verify passes bulk
    copies (UBLKCP), the int8 verify pass int8 mma.sync (IMMA), B5's two
    kernels present (its FFT on the CUDA cores), the decoder MLP's two kernels
    cp.async copies (LDGSTS), ldmatrix (LDSM) and bf16 mma.sync (HMMA), and
    of the fused attention blocks the LN-and-product kernel cp.async copies
    and fp64 mma.sync (DMMA), B10a's attention cp.async copies, B10b's bulk
    copies and the O product cp.async, ldmatrix and bf16 mma.sync.
    Returns the pick kernel's instructions a group of four ids
    (``pick_loop_counts``), None without cuobjdump."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("[sass] cuobjdump not found: instruction counts not read",
              flush=True)
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    # the mangled names, with their lengths: no other kernel's name ends so
    want = {"11attn_kernelE": ("HGMMA", "UTMALDG"),
            "11gemm_kernelI": ("HGMMA", "UTMALDG"),
            "16self_step_kernelE": ("UBLKCP",),
            "21self_step_int8_kernelE": ("UBLKCP",),
            "19mel_spectrum_kernelI": (),
            "20mel_normalize_kernelE": (),
            "17cross_step_kernelE": ("UBLKCP",),
            "20cross_dequant_kernelE": ("UBLKCP",),
            "26cross_multi_dequant_kernelE": ("UBLKCP",),
            "23cross_multi_int8_kernelE": ("UBLKCP", "IMMA"),
            "14ln_gemm_kernelE": ("LDGSTS", "DMMA"),
            "16self_attn_kernelE": ("LDGSTS",),
            "17cross_attn_kernelE": ("UBLKCP",),
            "15out_proj_kernelE": ("LDGSTS", "LDSM", "HMMA"),
            "10fc1_kernelE": ("LDGSTS", "LDSM", "HMMA"),
            "10fc2_kernelE": ("LDGSTS", "LDSM", "HMMA")}
    seen = set()
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        for kernel, ops in want.items():
            if kernel not in name:
                continue
            seen.add(kernel)
            counts = {op: len(re.findall(rf"\b{op}\b", part))
                      for op in ops + ("SYNCS", "MUFU")}
            print(f"[sass] {kernel[2:-1]}: {counts}", flush=True)
            missing = [op for op in ops if counts[op] == 0]
            if missing:
                raise AssertionError(f"{kernel[2:-1]}: no {missing} in its "
                                     "SASS")
    if seen != set(want):
        raise AssertionError(f"kernels not found in the SASS: "
                             f"{sorted(set(want) - seen)}")
    pick = pick_loop_counts(sass)
    print(f"[sass] gumbel_pick_kernel: a group of four ids "
          f"{pick['issue']:g} instructions ({pick['int']:g} integer, "
          f"{pick['mufu']:g} MUFU and conversions, {pick['mem']:g} loads and "
          f"stores), {pick['groups_a_pass']} group(s) a pass of its loop; "
          f"the loop's opcodes {pick['opcodes']}", flush=True)
    return pick


def check_kernels(card: str, pick_sass) -> list:
    """Each kernel against its plain version at its path's shapes;
    pick_sass: the pick kernel's instructions a group (``check_sass``, None
    without cuobjdump), whose issue time is printed beside its bound."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import synth_audio
    from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
    from whisper_tpu_torch.ops import decoder_kernels, encoder_block
    from whisper_tpu_torch.ops import kernels, log_mel, sampling
    from whisper_tpu_torch.ops import self_attention
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket
    from whisper_tpu_torch.profile_ladder import mel_composition

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    b, h, t, dh, d, f = 16, 8, 1500, 64, 512, 2048
    n_l, s_max, layer, pos = 6, 132, 3, 70
    rows = []
    # name -> (bytes moved, operations, their type) of one call, for the
    # bound; and the one PyTorch call that computes the same function,
    # where there is one.
    work, library = {}, {}
    n = b * t                                         # encoder rows

    # B1: q pre-scaled, as the encoder passes it.
    q, k, v = randn(b, h, t, dh, scale=dh ** -0.5), randn(b, h, t, dh), \
        randn(b, h, t, dh)
    rows.append(("fused_attention", (attention, "launches"), "attention.cu",
                 "whisper_tpu/ops/attention.py:75",
                 lambda: attention.fused_attention(q, k, v),
                 lambda: attention.fused_attention_plain(q, k, v), 2.0))
    work["fused_attention"] = (4 * b * h * t * dh * 2,
                               4 * b * h * t * t * dh, "bf16")
    library["fused_attention"] = \
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=1.0)

    # B2: dequantized int8 weights, as the encoder passes them.
    x = randn(b, t, d)
    ln_s, ln_b = 1.0 + randn(d, scale=0.1), randn(d, scale=0.1)
    w1 = (torch.randint(-127, 128, (d, f), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    w2 = (torch.randint(-127, 128, (f, d), generator=g, device=dev).to(bf)
          * torch.tensor(3e-4, dtype=bf))
    b1, b2 = randn(f, scale=0.1), randn(d, scale=0.1)
    mlp_args = (x, ln_s, ln_b, w1, b1, w2, b2)
    rows.append(("fused_encoder_mlp", (encoder_mlp, "launches"),
                 "encoder_mlp.cu", "whisper_tpu/ops/encoder_mlp.py:224",
                 lambda: encoder_mlp.fused_encoder_mlp(*mlp_args),
                 lambda: encoder_mlp.fused_encoder_mlp_plain(*mlp_args), 2.0))
    work["fused_encoder_mlp"] = ((2 * n * d + 2 * d * f + 3 * d + f) * 2,
                                 4 * n * d * f, "bf16")

    # B2 at whisper-medium's width (the TPU's FFN-chunked kernel, B2c):
    # the 4 s file of the CLI phase is one chunk, bucket 1.
    dm, fm = 1024, 4096
    xm = randn(1, t, dm)
    med_args = (xm, 1.0 + randn(dm, scale=0.1), randn(dm, scale=0.1),
                (torch.randint(-127, 128, (dm, fm), generator=g, device=dev)
                 .to(bf) * torch.tensor(2e-4, dtype=bf)), randn(fm, scale=0.1),
                (torch.randint(-127, 128, (fm, dm), generator=g, device=dev)
                 .to(bf) * torch.tensor(2e-4, dtype=bf)), randn(dm, scale=0.1))
    rows.append(("fused_encoder_mlp_d1024", (encoder_mlp, "launches"),
                 "encoder_mlp.cu", "whisper_tpu/ops/encoder_mlp.py:163",
                 lambda: encoder_mlp.fused_encoder_mlp(*med_args),
                 lambda: encoder_mlp.fused_encoder_mlp_plain(*med_args), 2.0))
    work["fused_encoder_mlp_d1024"] = (
        (2 * t * dm + 2 * dm * fm + 3 * dm + fm) * 2, 4 * t * dm * fm, "bf16")

    # B3: the kernel writes row `pos` of the cache in place, so the kernel
    # and the plain version each get their own copy.
    qs, kn, vn = randn(b, h, dh, scale=dh ** -0.5), randn(b, h, dh), \
        randn(b, h, dh)
    kc, vc = randn(n_l, b, h, s_max, dh), randn(n_l, b, h, s_max, dh)
    kc2, vc2 = kc.clone(), vc.clone()
    # no pad_count, as the x5 step calls it
    rows.append(("self_attend_step", (self_attention, "launches"),
                 "self_attention.cu",
                 "whisper_tpu/ops/self_attention.py:470",
                 lambda: self_attention.self_attend_step(
                     qs, kn, vn, kc, vc, layer, pos),
                 lambda: self_attention.self_attend_step_plain(
                     qs, kn, vn, kc2, vc2, layer, pos), 2.0))
    # Rows [pad, pos] of K and V are read (the data decides how many), the
    # new row written; scores and P.V in fp32 on the CUDA cores.
    work["self_attend_step"] = (
        b * h * dh * 2 * (2 * (pos + 1) + 6), 4 * b * h * (pos + 1) * dh,
        "fp32")

    # B8 (x7): the same step against the int8 self cache with per-row
    # scales; the kernel and the plain version each get their own copies
    # of the four buffers they write.  No pad_count, as the x7 step calls it.
    i8 = self_attention.quantize_self_cache(kc, vc)
    i8_plain = [x.clone() for x in i8]
    rows.append(("self_attend_step_int8", (self_attention, "int8_launches"),
                 "self_attention_int8.cu",
                 "whisper_tpu/ops/self_attention.py:327",
                 lambda: self_attention.self_attend_step_int8(
                     qs, kn, vn, *i8, layer, pos),
                 lambda: self_attention.self_attend_step_int8_plain(
                     qs, kn, vn, *i8_plain, layer, pos), 2.0))
    work["self_attend_step_int8"] = (
        b * h * (2 * (pos + 1) * (dh + 4) + 4 * dh * 2 + 2 * (dh + 4)),
        4 * b * h * (pos + 1) * dh, "int8")

    # B4: the int8 cross cache as quantize_cross_kv leaves it.
    qx = randn(b, h, dh, scale=dh ** -0.5)
    k8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                       device=dev, dtype=torch.int8)
    ks = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
    rows.append(("cross_attend_step", (cross_attention, "launches"),
                 "cross_attention.cu",
                 "whisper_tpu/ops/cross_attention.py:533",
                 lambda: cross_attention.cross_attend_step(
                     qx, k8, v8, ks, vs, 2, s_valid=t),
                 lambda: cross_attention.cross_attend_step_plain(
                     qx, k8, v8, ks, vs, 2, s_valid=t), 2.0))
    cross_bytes = b * h * (2 * t * dh + 2 * dh * 2 + 8)
    work["cross_attend_step"] = (cross_bytes, 4 * b * h * t * dh, "int8")
    work["cross_attend_step_dequant"] = (cross_bytes, 4 * b * h * t * dh,
                                         "fp32")

    # B6 (x4): the same cache, dequantized in the kernel.
    rows.append(("cross_attend_step_dequant",
                 (cross_attention, "dequant_launches"),
                 "cross_attention_dequant.cu",
                 "whisper_tpu/ops/cross_attention.py:533",
                 lambda: cross_attention.cross_attend_step_dequant(
                     qx, k8, v8, ks, vs, 2, s_valid=t),
                 lambda: cross_attention.cross_attend_step_dequant_plain(
                     qx, k8, v8, ks, vs, 2, s_valid=t), 2.0))

    # B5: a file at the one-shot limit (7,680 valid frames in its
    # 12,000-frame bucket), int16 upload as at x3+; tolerance 1e-4 on the
    # normalized mel, the card-vs-CPU mel bound of check_against_cpu.
    nv = 7680
    audio = synth_audio(nv * golden.HOP / 16000.0)
    pcm = np.round(np.clip(golden.reflect_pad(audio), -1, 1) * 32767.0)
    wire = torch.from_numpy(pcm.astype(np.int16)).to(dev)
    nf = mel_frame_bucket(nv)
    rows.append(("log_mel", (log_mel, "launches"), "log_mel.cu",
                 "whisper_tpu/ops/pallas_mel.py:129",
                 lambda: log_mel.log_mel(wire, nv, 80, nf),
                 lambda: log_mel.log_mel_plain(wire, nv, 80, nf), 1e-4))
    # What the inputs need: the valid frames' samples, the [80, n_frames]
    # output and the tables (twiddles, window, bands, weights) once; per
    # valid frame an FFT of 400 real points (2.5 N log2 N), the power of 201
    # bins (3 operations each) and the 391 nonzero mel weights (2 each).
    tables = sum(x.numel() * x.element_size()
                 for x in log_mel._device_tables(torch.device(dev), 80))
    nnz = log_mel.mel_bands(80)[1].size
    work["log_mel"] = (((nv - 1) * golden.HOP + golden.WIN) * 2
                       + 80 * nf * 4 + tables,
                       nv * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * nnz),
                       "fp32")
    library["log_mel"] = lambda: mel_composition(wire, nv, 80, nf)

    # B9a and B9b: one encoder layer's two kernels (fused_encoder_block),
    # dequantized int8 weights as the encoder passes them.
    def qweight(rows_, cols, s=3e-4):
        return (torch.randint(-127, 128, (rows_, cols), generator=g,
                              device=dev).to(bf) * torch.tensor(s, dtype=bf))

    w_qkv, b_qkv = qweight(d, 3 * d), randn(3 * d, scale=0.1)
    qkv_args = (x, ln_s, ln_b, w_qkv, b_qkv)
    rows.append(("fused_ln_qkv", (encoder_block, "ln_qkv_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:178",
                 lambda: encoder_block.fused_ln_qkv(*qkv_args),
                 lambda: encoder_block.fused_ln_qkv_plain(*qkv_args), 2.0))
    work["fused_ln_qkv"] = ((n * d + n * 3 * d + d * 3 * d + 5 * d) * 2,
                            2 * n * d * 3 * d, "bf16")
    qkv_med = (xm, med_args[1], med_args[2], qweight(dm, 3 * dm, 2e-4),
               randn(3 * dm, scale=0.1))
    rows.append(("fused_ln_qkv_d1024", (encoder_block, "ln_qkv_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:178",
                 lambda: encoder_block.fused_ln_qkv(*qkv_med),
                 lambda: encoder_block.fused_ln_qkv_plain(*qkv_med), 2.0))
    work["fused_ln_qkv_d1024"] = (
        (t * dm + t * 3 * dm + dm * 3 * dm + 5 * dm) * 2,
        2 * t * dm * 3 * dm, "bf16")
    out_args = (x, randn(b, t, d), qweight(d, d), randn(d, scale=0.1), ln_s,
                ln_b, w1, b1, w2, b2)
    rows.append(("fused_out_mlp", (encoder_block, "out_mlp_launches"),
                 "encoder_block.cu", "whisper_tpu/ops/encoder_block.py:257",
                 lambda: encoder_block.fused_out_mlp(*out_args),
                 lambda: encoder_block.fused_out_mlp_plain(*out_args), 2.0))
    work["fused_out_mlp"] = ((3 * n * d + d * d + 2 * d * f + 4 * d + f) * 2,
                             2 * n * d * (d + 2 * f), "bf16")

    # B10c: the decoder MLP of one step (the hybrid step), bucket 16.
    mlp_step = (randn(b, d), torch.stack([ln_s, ln_b]), w1, b1[None], w2,
                b2[None])
    rows.append(("decoder_mlp_block", (decoder_kernels, "launches"),
                 "decoder_mlp.cu", "whisper_tpu/ops/decoder_kernels.py:270",
                 lambda: decoder_kernels.mlp_block(*mlp_step),
                 lambda: decoder_kernels.mlp_block_plain(*mlp_step), 2.0))
    work["decoder_mlp_block"] = ((2 * b * d + 2 * d * f + 3 * d + f) * 2,
                                 4 * b * d * f, "bf16")

    # B7: the verify pass of speculative decoding at draft_k = 4, five
    # queries a row against the cache B4 and B6 read; int8 x int8 (x5) and
    # dequantizing (x4).  One stream of K and V for all five.
    n_q = 5
    qm = randn(b, n_q, h, dh, scale=dh ** -0.5)
    for name, mxu, kind in (("cross_attend_multi", True, "int8"),
                            ("cross_attend_multi_dequant", False, "fp32")):
        rows.append((name, (cross_attention, "multi_launches"),
                     "cross_attention_multi.cu",
                     "whisper_tpu/ops/cross_attention.py:398",
                     lambda mxu=mxu: cross_attention.cross_attend_multi(
                         qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu),
                     lambda mxu=mxu: cross_attention.cross_attend_multi_plain(
                         qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu),
                     2.0))
        work[name] = (b * h * (2 * t * dh + 8) + 2 * b * n_q * h * dh * 2,
                      4 * b * n_q * h * t * dh, kind)

    # B10a and B10b: a layer's two attention blocks of the fully fused
    # decode step.  B10a writes row `pos` of the time-major self cache in
    # place, so the kernel and the plain version each get their own copy.
    xs = randn(b, d)
    ln2 = torch.stack([ln_s, ln_b])
    qkv_w1, qkv_b1 = qweight(d, 3 * d), randn(1, 3 * d, scale=0.1)
    o_w1, o_b1 = qweight(d, d), randn(1, d, scale=0.1)
    tk, tv = randn(s_max, b, d), randn(s_max, b, d)
    tk2, tv2 = tk.clone(), tv.clone()
    self_args = (xs, ln2, qkv_w1, qkv_b1, o_w1, o_b1)
    rows.append(("decoder_self_block",
                 (decoder_kernels, "self_block_launches"),
                 "decoder_self_block.cu",
                 "whisper_tpu/ops/decoder_kernels.py:120",
                 lambda: decoder_kernels.self_attn_block(
                     *self_args, tk, tv, pos, h)[0],
                 lambda: decoder_kernels.self_attn_block_plain(
                     *self_args, tk2, tv2, pos, h)[0], 2.0))
    work["decoder_self_block"] = (
        (4 * d * d + 6 * d + 2 * b * d + 2 * (pos + 1) * b * d) * 2,
        2 * b * d * 4 * d + 4 * b * (pos + 1) * d, "bf16")
    xk, xv = randn(b, h, t, dh), randn(b, h, t, dh)
    cross_args = (xs, ln2, o_w1, o_b1, qweight(d, d), randn(1, d, scale=0.1))
    rows.append(("decoder_cross_block",
                 (decoder_kernels, "cross_block_launches"),
                 "decoder_cross_block.cu",
                 "whisper_tpu/ops/decoder_kernels.py:222",
                 lambda: decoder_kernels.cross_attn_block(
                     *cross_args, xk, xv, h),
                 lambda: decoder_kernels.cross_attn_block_plain(
                     *cross_args, xk, xv, h), 2.0))
    # bf16 K and V streamed once; the scores and P.V in fp32.
    work["decoder_cross_block"] = (
        (2 * b * h * t * dh + 2 * d * d + 4 * d + 2 * b * d) * 2,
        4 * b * h * t * dh + 4 * b * d * d, "fp32")

    # The sampled pick of a decode step at T > 0 (no Pallas counterpart:
    # the JAX loop draws with jax.random.categorical, the key in its carry):
    # bucket 16 over whisper-base's vocabulary, suppressed ids at -inf, T,
    # the key and the step on the card; the ids, and the uniforms and
    # scores it writes when asked, bitwise the plain version's.
    vocab = 51865
    pick_logits = torch.randn(b, vocab, generator=g, device=dev) * 4.0
    pick_logits[:, ::50] = float("-inf")
    pick_args = (pick_logits, torch.full((1,), 0.5, device=dev),
                 sampling.generator_key(
                     torch.Generator(device=dev).manual_seed(3), dev),
                 torch.full((1,), 7, dtype=torch.int64, device=dev))
    pick_ws = sampling.pick_workspace(b, dev)   # as a decode's state holds
    rows.append(("gumbel_pick", (sampling, "launches"), "gumbel_pick.cu",
                 "none: whisper_tpu/runtime/generate.py:97 (pick draws with "
                 "jax.random.categorical)",
                 lambda: sampling.gumbel_pick(*pick_args, workspace=pick_ws),
                 lambda: sampling.gumbel_pick_plain(*pick_args), 0.0))
    # the logits read once, the ids written; against the instructions the
    # function needs (``pick_work_ms``)
    pick_bytes = b * vocab * 4 + b * 8
    pick_work = pick_work_ms(pick_logits)
    pick_bytes_ms = _bound(pick_bytes, 0, "fp32")[0]
    bound_of = {"gumbel_pick": (max(pick_bytes_ms, pick_work),
                                "bytes" if pick_bytes_ms >= pick_work
                                else "operations")}

    # What a launch through the library's C interface costs when the kernel
    # does nothing: the floor under every kernel whose bound is microseconds.
    lib = kernels.library()
    stream = kernels.stream_ptr(torch.device(dev))
    floor_ms = _median_ms(
        lambda: kernels.check(lib.wt_launch_floor(stream), "launch_floor"))
    print(f"[kernel] launch floor: an empty kernel through the same ctypes "
          f"route {floor_ms:.4f} ms a call on {card}", flush=True)

    out = []
    for name, counter, src, replaces, kern, plain, tol in rows:
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        if got.dtype == torch.float32:  # B5: absolute error of the mel
            steps, unit = err, "abs"
        else:
            steps, unit = _bf16_steps(got, want), "bf16 steps"
        if steps > tol:
            raise AssertionError(f"{name}: {steps:.3g} {unit} from the "
                                 f"plain version (tolerance {tol})")
        # the in-place inserts must leave every buffer bitwise equal to
        # the plain version's
        written = {"self_attend_step": ((kc, kc2), (vc, vc2)),
                   "self_attend_step_int8": tuple(zip(i8, i8_plain)),
                   "decoder_self_block": ((tk, tk2), (tv, tv2))}
        for mine, theirs in written.get(name, ()):
            if not torch.equal(mine, theirs):
                raise AssertionError(f"{name}: a cache buffer differs from "
                                     "the plain version's after the insert")
        if name == "gumbel_pick":
            draws = sampling.gumbel_pick(*pick_args, with_draws=True)[1:]
            plain_draws = sampling.gumbel_scores_plain(*pick_args)
            if not (torch.equal(got, want) and all(
                    torch.equal(m_, p_) for m_, p_ in zip(draws,
                                                          plain_draws))):
                raise AssertionError("gumbel_pick: the ids, uniforms or "
                                     "scores are not bitwise the plain "
                                     "version's")
        ms, plain_ms = _median_ms(kern), _median_ms(plain)
        bound_ms, bound_by = bound_of.get(name) or _bound(*work[name])
        library_ms = _median_ms(library[name]) if name in library else None
        print(f"[kernel] {name}: max_abs_err {err:.3g} ({steps:.3g} {unit}, "
              f"tolerance {tol}); {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms by {bound_by}, library call "
              + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
              + (f", an empty launch {floor_ms:.4f} ms" if bound_ms < 0.02
                 else "") + f" on {card}", flush=True)
        out.append({"name": name, "route": "cuda",
                    "source": f"whisper_tpu_torch/csrc/{src}",
                    "replaces": replaces, "counter": counter,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
        if bound_ms < 0.02:
            out[-1]["launch_floor_ms"] = floor_ms

    by_name = {r["name"]: r for r in out}
    comp_ms = _median_ms(lambda: _mlp_composition(*mlp_step))
    by_name["decoder_mlp_block"]["composition_ms"] = comp_ms
    print(f"[kernel] B10c at bucket 16, d = {d}: "
          f"{by_name['decoder_mlp_block']['ms']:.4f} ms against a composition "
          f"of five PyTorch calls in bf16 (layer_norm, linear, gelu, linear, "
          f"add; no one call computes B10c) {comp_ms:.4f} ms on {card}",
          flush=True)
    comp_ms = _median_ms(lambda: _pick_composition(*pick_args[:2]))
    pick = by_name["gumbel_pick"]
    pick["composition_ms"] = comp_ms
    pick.update(check_pick_in_graphs(pick_args, pick_ws))
    ops = _device_ops_per_call(
        lambda: sampling.gumbel_pick(*pick_args, workspace=pick_ws))
    if ops != 1:
        raise AssertionError(f"gumbel_pick: {ops} device operations a call, "
                             "expected its one kernel")
    groups = b * -(-vocab // 4)
    pick["sass_issue_ms"] = (issue_ms(pick_sass, groups) if pick_sass
                             else None)
    print(f"[kernel] the sampled pick at bucket {b}, V = {vocab}: ids, "
          f"uniforms and scores bitwise the plain version's, one kernel a "
          f"call; the wrapper {pick['ms']:.4f} ms a call (host-bound), in a "
          f"graph of 128 picks {pick['device_us']:.3f} µs a call on the "
          f"card, at bucket 1 {pick['device_us_bucket1']:.3f} µs; bound "
          f"{pick['bound_ms'] * 1e3:.3f} µs by {pick['bound_by']} (bytes "
          f"{pick_bytes_ms * 1e3:.3f} µs, the function's instructions "
          f"{pick_work * 1e3:.3f} µs); the kernel's own loop, {groups} "
          f"groups of four ids at "
          + (f"{pick_sass['issue']:g} instructions a group from its SASS "
             f"({pick_sass['int']:g} integer, {pick_sass['mufu']:g} MUFU and "
             f"conversions), issues in {pick['sass_issue_ms'] * 1e3:.3f} µs"
             if pick_sass else "not read (no cuobjdump)")
          + f"; the composition exponential_, clamp_min_, log, div, sub, "
          f"argmax (no one call samples from logits) {comp_ms:.4f} ms; "
          f"on {card}", flush=True)
    check_b1_b4_edges(card, by_name, randn, q.shape, (qx, k8, v8, ks, vs))
    check_b6_edges(card, by_name, randn, (qx, k8, v8, ks, vs), qm)
    check_b2_b3_edges(card, by_name, randn, mlp_args, med_args,
                      (qs, kn, vn, kc, vc))
    check_b9_edges(card, by_name, randn, qkv_args, qkv_med, out_args)
    check_b8_b5_edges(card, by_name, randn, (qs, kn, vn, kc, vc), wire)

    # B7 against the kernels it repeats: every query bitwise the
    # single-token kernel's (B4, B6) on that query, at T = 1, 2, 5, 9 and 17
    # (both take their queries in chunks of 8) and S = 96, 193, 1500, 1504
    # (1,500 valid) and 2000 (1,999 valid: eleven segments), and its time
    # beside T calls of that kernel.
    caches = {t: (k8, v8, ks, vs, 2)}
    for s_ in (96, 193, 1504, 2000):
        caches[s_] = (torch.randint(-127, 128, (2, b, h, s_, dh), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.randint(-127, 128, (2, b, h, s_, dh), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.rand(2, b, h, generator=g, device=dev) * 0.02
                      + 1e-3,
                      torch.rand(2, b, h, generator=g, device=dev) * 0.02
                      + 1e-3, 1)
    valid_of = {96: 96, 193: 193, t: t, 1504: 1500, 2000: 1999}
    for mxu, one, label in ((True, cross_attention.cross_attend_step, "B4"),
                            (False, cross_attention.cross_attend_step_dequant,
                             "B6")):
        for (s_, (*cache, lay)), n_t in itertools.product(caches.items(),
                                                         (1, 2, 5, 9, 17)):
            qt = randn(b, n_t, h, dh, scale=dh ** -0.5)
            valid = valid_of[s_]
            got = cross_attention.cross_attend_multi(
                qt, *cache, lay, s_valid=valid, int8_mxu=mxu)
            for i in range(n_t):
                want = one(qt[:, i].contiguous(), *cache, lay, s_valid=valid)
                if not torch.equal(got[:, i], want):
                    raise AssertionError(
                        f"B7 (int8_mxu={mxu}), T = {n_t}, S = {s_}: query "
                        f"{i} is not bitwise {label}'s")
            plain = cross_attention.cross_attend_multi_plain(
                qt, *cache, lay, s_valid=valid, int8_mxu=mxu)
            if _bf16_steps(got, plain) > 2.0:
                raise AssertionError(f"B7 (int8_mxu={mxu}), T = {n_t}, S = "
                                     f"{s_}: {_bf16_steps(got, plain):.3g} "
                                     "bf16 steps from the plain version")
        q1 = qm[:, 0].contiguous()
        one_ms = _median_ms(lambda: one(q1, k8, v8, ks, vs, 2, s_valid=t))
        multi_ms = _median_ms(lambda: cross_attention.cross_attend_multi(
            qm, k8, v8, ks, vs, 2, s_valid=t, int8_mxu=mxu))
        print(f"[kernel] B7 (int8_mxu={mxu}): every query bitwise {label}'s "
              f"at T = 1, 2, 5, 9, 17 and S = 96, 193, 1500, 1504, 2000; T = "
              f"{n_q}: {multi_ms:.4f} ms against "
              f"{n_q} x {label} = {n_q * one_ms:.4f} ms on {card}",
              flush=True)

    # B10a at the first, the path's and the last cache row, with `pos` as an
    # int and as a device tensor; B10b at the path's encoder, a short one,
    # one whose length is no multiple of its 64-key blocks and one whose
    # split leaves a short last key block (1,731: three keys); two calls of
    # each bitwise equal, and each call at most three device operations.
    for p_, form in itertools.product((0, pos, s_max - 1), ("int", "tensor")):
        a, b_, c_ = ([x.clone() for x in (tk, tv)] for _ in range(3))
        p_arg = (torch.tensor([p_], dtype=torch.int32, device=dev)
                 if form == "tensor" else p_)
        got = decoder_kernels.self_attn_block(*self_args, *a, p_arg, h)[0]
        want = decoder_kernels.self_attn_block_plain(*self_args, *b_, p_,
                                                     h)[0]
        again = decoder_kernels.self_attn_block(*self_args, *c_, p_arg, h)[0]
        steps = _bf16_steps(got, want)
        same = all(torch.equal(m_, t_) for m_, t_ in zip(a, b_))
        kept = all(torch.equal(m_[p_ + 1:], o_[p_ + 1:])
                   and torch.equal(m_[:p_], o_[:p_])
                   for m_, o_ in zip(a, (tk, tv)))
        repeat = torch.equal(got, again) and all(
            torch.equal(m_, t_) for m_, t_ in zip(a, c_))
        if steps > 2.0 or not (same and kept and repeat):
            raise AssertionError(f"B10a at pos {p_} ({form}): {steps:.3g} "
                                 f"bf16 steps, caches bitwise {same}, other "
                                 f"rows untouched {kept}, two calls bitwise "
                                 f"{repeat}")
    xk_long, xv_long = randn(b, h, 1731, dh), randn(b, h, 1731, dh)
    for t_enc in (t, 96, 100, 1731):
        src_k, src_v = (xk, xv) if t_enc <= t else (xk_long, xv_long)
        xk_s = src_k[:, :, :t_enc].contiguous()
        xv_s = src_v[:, :, :t_enc].contiguous()
        got = decoder_kernels.cross_attn_block(*cross_args, xk_s, xv_s, h)
        steps = _bf16_steps(
            got, decoder_kernels.cross_attn_block_plain(*cross_args, xk_s,
                                                        xv_s, h))
        repeat = torch.equal(got, decoder_kernels.cross_attn_block(
            *cross_args, xk_s, xv_s, h))
        if steps > 2.0 or not repeat:
            raise AssertionError(f"B10b at T = {t_enc}: {steps:.3g} bf16 "
                                 "steps from the plain version, two calls "
                                 f"bitwise {repeat}")
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    for name, fn in (
            ("decoder_self_block", lambda: decoder_kernels.self_attn_block(
                *self_args, tk, tv, pos_t, h)),
            ("decoder_cross_block", lambda: decoder_kernels.cross_attn_block(
                *cross_args, xk, xv, h))):
        ops = _device_ops_per_call(fn)
        if ops > 3:
            raise AssertionError(f"{name}: {ops} device operations a call, "
                                 "expected its three kernels")
        by_name[name]["device_ops_per_call"] = ops
    print(f"[kernel] B10a at pos 0, {pos}, {s_max - 1} (int and device "
          "tensor): caches bitwise the plain version's, other rows "
          f"untouched; B10b at T = {t}, 96, 100, 1731 within 2 bf16 steps; "
          "two calls of each bitwise equal; device operations a call: B10a "
          f"{by_name['decoder_self_block']['device_ops_per_call']:g}, B10b "
          f"{by_name['decoder_cross_block']['device_ops_per_call']:g}",
          flush=True)
    out.extend(check_loop_tail(card))
    return out


def _graph_us(fn, calls: int = 128, runs: int = 5) -> float:
    """Device µs a call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the replay timed with CUDA events, the median of ``runs``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def check_pick_in_graphs(pick_args, pick_ws) -> dict:
    """The pick's device µs a call from a graph of 128 picks, at the path's
    bucket and at bucket 1; every replayed id bitwise the plain
    version's."""
    import torch

    from whisper_tpu_torch.ops import sampling

    logits, temp, key, step = pick_args
    out = {}
    for label, rows in (("", logits.shape[0]), ("_bucket1", 1)):
        args = (logits[:rows].contiguous(), temp, key, step)
        ws = pick_ws[:rows].contiguous()
        got = {}

        def pick():
            got["tok"] = sampling.gumbel_pick(*args, workspace=ws)

        out["device_us" + label] = _graph_us(pick)
        torch.cuda.synchronize()
        if not torch.equal(got["tok"], sampling.gumbel_pick_plain(*args)):
            raise AssertionError(f"gumbel_pick ({rows} rows): a replayed id "
                                 "differs from the plain version's")
    return out


def _node_graph(done, trips, bound: int, body, tail: bool = False):
    """One CUDA graph holding one while node (``runtime.generate._while_node``)
    on ``done`` and ``trips`` under ``bound``, whose body is ``body()``
    (warmed by the caller); with ``tail`` the body's loop tail sets the
    condition, else C ends the body.  (graph, the node's info)."""
    import torch

    from whisper_tpu_torch.runtime.generate import _while_node

    dev = done.device
    side, inner = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with _while_node(graph, done, trips, bound, inner,
                             tail=tail) as info:
                body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph, info


def _flat_graph(fn, calls: int = 128, warm: bool = True):
    """``calls`` calls of ``fn`` captured in one flat CUDA graph on a side
    stream, after one warm-up call where ``warm``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        if warm:
            fn()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            for _ in range(calls):
                fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def _replay_us(graphs: dict, resets: dict, trips: int = 128,
               replays: int = 20, runs: int = 5) -> dict:
    """µs a trip of each graph ({name: graph}; a trip: a launch of a flat
    graph's kernel, an iteration of a while node): CUDA events around each
    replay alone, after its reset (``resets``: {name: fn}, queued outside
    the events), the mean of ``replays`` replays over ``trips``, the median
    of ``runs``; the graphs in turns, forward and back, the two means."""
    import torch

    def reset(name):
        if name in resets:
            resets[name]()

    def one(name):
        times = []
        for _ in range(runs):
            events = []
            for _ in range(replays):
                reset(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graphs[name].replay()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            times.append(statistics.mean(s.elapsed_time(e)
                                         for s, e in events))
        return statistics.median(times) * 1e3 / trips

    for name in graphs:              # the first launch uploads the graph
        reset(name)
        graphs[name].replay()
    torch.cuda.synchronize()
    us = {name: [] for name in graphs}
    for name in [*graphs, *reversed(graphs)]:
        us[name].append(one(name))
    return {name: statistics.mean(v) for name, v in us.items()}


# the greedy step's tail, checked bitwise against its plain version: rows,
# steps (the first column and the last of 128), scores
TAIL_ROWS, TAIL_COLS = (1, 16, 64, 1025), 128
EOT_ID = 50257


def _tail_state(g, b: int, step: int, scores: bool, seed: int,
                cols: int = TAIL_COLS):
    """A loop state before a step at column ``step`` on the card: [nxt,
    lp, done, buf, last, pos, step, sum_lp, n_tok]; row r is done before
    the step, ends at it (picks EOT) or goes on by (r + seed) % 3; with
    scores sum_lp holds -0.0 in row 0 and lp a NaN in the last row."""
    import torch

    dev = "cuda"
    kind = (torch.arange(b, device=dev) + seed) % 3
    nxt = torch.randint(0, 50000, (b,), generator=g, device=dev)
    st = [torch.where(kind == 1, EOT_ID, nxt), None, kind == 0,
          torch.randint(0, 51865, (b, cols), generator=g, device=dev),
          torch.randint(0, 51865, (b,), generator=g, device=dev),
          torch.full((1,), 4 + step, dtype=torch.int32, device=dev),
          torch.full((1,), step, dtype=torch.int64, device=dev), None, None]
    if scores:
        lp = torch.randn(b, generator=g, device=dev) - 3.0
        lp[-1] = float("nan")
        sum_lp = torch.randn(b, generator=g, device=dev) * 10.0 - 30.0
        sum_lp[0] = -0.0
        st[1], st[7] = lp, sum_lp
        st[8] = torch.randint(1, 128, (b,), generator=g, device=dev)
    return st


def _tail_err(got, want) -> tuple:
    """(bitwise, the largest |difference|) of two states' outputs, floats
    by their bits, NaNs in the same places counting as no difference."""
    import torch

    same, err = True, 0.0
    for a, b in zip(got[2:], want[2:]):
        if a is None:
            continue
        d = (a.double() - b.double()).abs()
        if a.is_floating_point():
            same &= torch.equal(a.view(torch.int32), b.view(torch.int32))
            d[torch.isnan(a) & torch.isnan(b)] = 0.0
        else:
            same &= torch.equal(a, b)
        err = max(err, float(d.max()))
    return same, err


def check_loop_tail(card: str) -> list:
    """The greedy step's tail (``ops.loop_tail``, ``wt_loop_tail`` in
    ``csrc/graph_cond.cu``) and the while node's condition kernel (C):
    their rows of the kernels line.  The tail bitwise its plain version at
    1, 16, 64 and 1,025 rows (one block, rows in turn), at step 0 and the
    last column, rows done before it, ending at it and going on, with and
    without scores; one kernel a call (the nodes of a while node's body of
    one tail); its wrapper's ms and the plain version's at bucket 16
    without scores (the main path's).  C: the trips a while node runs with
    C ending a counting body, against its plain version's loop
    (``condition_plain``), with every row done, some, none, and bounds 0,
    5 and 128; its plain version's ms.  The bounds are bytes.  Their device
    µs alone, in flat graphs of 128, come from ``[graph]`` (g)
    (``check_while_node``), timed in turns with the node."""
    import torch

    from whisper_tpu_torch.ops import kernels, loop_tail

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(23)
    err, cases = 0.0, 0
    for b, step, scores, seed in itertools.product(
            TAIL_ROWS, (0, TAIL_COLS - 1), (False, True), range(3)):
        got = _tail_state(g, b, step, scores, seed)
        want = [None if t is None else t.clone() for t in got]
        before = loop_tail.launches
        loop_tail.loop_tail(*got, eot_id=EOT_ID)
        loop_tail.loop_tail_plain(*want, eot_id=EOT_ID)
        torch.cuda.synchronize()
        same, e = _tail_err(got, want)
        if not same or loop_tail.launches != before + 1:
            raise AssertionError(
                f"loop_tail at {b} rows, step {step}, scores {scores}, seed "
                f"{seed}: not bitwise its plain version (largest difference "
                f"{e:.3g}), or {loop_tail.launches - before} launches")
        err, cases = max(err, e), cases + 1
    b = 16
    states = [_tail_state(g, b, 0, False, 1) for _ in range(3)]
    ms = _median_ms(lambda: loop_tail.loop_tail(*states[0], eot_id=EOT_ID))
    plain_ms = _median_ms(lambda: loop_tail.loop_tail_plain(
        *states[1], eot_id=EOT_ID))
    # what a call puts on the card, read from a graph's nodes (torch.profiler
    # traces a few of this short kernel's launches): a while node's body of
    # one tail, which sets the node's condition
    st = states[2]
    _, info = _node_graph(st[2], st[6], TAIL_COLS,
                          lambda: loop_tail.loop_tail(*st, eot_id=EOT_ID),
                          tail=True)
    if info["body_ops"] != 1:
        raise AssertionError(f"loop_tail: {info['body_ops']} device "
                             "operations a call, expected its one kernel")
    # nxt and done read; buf's column, last and done written; pos and step
    # read and written
    tail_bound = _bound(b * (8 + 1 + 8 + 8 + 1) + 2 * (4 + 8), 0, "fp32")

    # C: the trips of a node whose counting body never ends a row
    lib = kernels.library()
    count = torch.zeros(1, dtype=torch.int64, device=dev)

    def bump():
        kernels.check(lib.wt_launch_count(count.data_ptr(),
                                          kernels.stream_ptr(dev)),
                      "launch_count")

    bump()
    c_err = 0
    for n_done, bound in ((0, 128), (15, 128), (16, 128), (0, 5), (0, 0)):
        done = torch.arange(b, device=dev) < n_done
        graph, _ = _node_graph(done, count, bound, bump)
        want = 0
        while bool(loop_tail.condition_plain(
                done, torch.full((1,), want, device=dev), bound)):
            want += 1
        for _ in range(2):
            count.zero_()
            graph.replay()
            torch.cuda.synchronize()
            c_err = max(c_err, abs(int(count) - want))
        if c_err:
            raise AssertionError(f"C: {int(count)} trips with {n_done} of "
                                 f"{b} rows done under {bound}, its plain "
                                 f"loop {want}")
    c_plain_ms = _median_ms(lambda: loop_tail.condition_plain(done, count,
                                                              128))
    c_bound = _bound(b + 8, 0, "fp32")
    print(f"[kernel] loop_tail (the greedy step's tail, csrc/graph_cond.cu):"
          f" bitwise its plain version in {cases} cases ({TAIL_ROWS} rows, "
          f"step 0 and {TAIL_COLS - 1}, rows done, ending and going on, "
          f"with and without scores), one kernel a call; at bucket {b} "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (the seven operations "
          f"it replaces), bound {tail_bound[0] * 1e3:.6f} µs by "
          f"{tail_bound[1]}; C (the while node's condition kernel): trips "
          f"as its plain loop's with 0, 15 and 16 of {b} rows done and "
          f"bounds 0, 5, 128, its plain version {c_plain_ms:.4f} ms, bound "
          f"{c_bound[0] * 1e3:.6f} µs by bytes ({b} bools and the 8-byte "
          f"counter); both alone on the card: [graph] (g), on {card}",
          flush=True)
    src = "whisper_tpu_torch/csrc/graph_cond.cu"
    return [
        {"name": "loop_tail", "route": "cuda", "source": src,
         "replaces": "none: whisper_tpu/runtime/generate.py:197-205 (the "
                     "while_loop body's update after its pick, which XLA "
                     "fuses)",
         "counter": (loop_tail, "launches"), "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": tail_bound[0],
         "bound_by": tail_bound[1], "library_ms": None},
        {"name": "while_condition", "route": "cuda", "source": src,
         "replaces": "none: whisper_tpu/runtime/generate.py:170-173 "
                     "(lax.while_loop's cond)",
         "counter": (loop_tail, "condition_launches"),
         "max_abs_err": float(c_err), "ms": None, "plain_ms": c_plain_ms,
         "bound_ms": c_bound[0], "bound_by": c_bound[1],
         "library_ms": None},
    ]


def _pick_composition(logits, temperature):
    """The sampled pick as PyTorch calls (the draw the loops made before the
    key moved into their state): argmax(logits / T - log E), E ~ Exp(1)
    from torch's generator, floored at the smallest normal float."""
    import torch

    e = torch.empty_like(logits).exponential_()
    return torch.argmax(logits / temperature - torch.log(
        e.clamp_min_(torch.finfo(torch.float32).tiny)), -1)


def _mlp_composition(x, ln, w1, b1, w2, b2):
    """B10c's function as five PyTorch calls in bf16 (the yardstick beside
    it: no one call computes it): B2's composition with B10c's stacked
    LayerNorm and [1, n] biases."""
    return _encoder_mlp_composition(x, ln[0], ln[1], w1, b1[0], w2, b2[0])


def _encoder_mlp_composition(x, ln_s, ln_b, w1, b1, w2, b2):
    """B2's function as five PyTorch calls in bf16 (layer_norm, linear,
    gelu, linear, add: no one call computes it)."""
    import torch.nn.functional as F

    r = F.layer_norm(x, x.shape[-1:], ln_s, ln_b, 1e-5)
    h = F.gelu(F.linear(r, w1.t(), b1), approximate="tanh")
    return x + F.linear(h, w2.t(), b2)


def _qkv_composition(x, ln_s, ln_b, w, bias):
    """B9a's function as two PyTorch calls in bf16 (layer_norm, linear: no
    one call computes it)."""
    import torch.nn.functional as F

    r = F.layer_norm(x, x.shape[-1:], ln_s, ln_b, 1e-5)
    return F.linear(r, w.t(), bias)


def _traced(fn):
    """``fn()`` under torch.profiler: profile_ladder's summary of the trace
    (device operations, busy ms, in-situ kernel times, call spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.profile_ladder import summarize

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return summarize(prof)


def _in_situ(summary) -> str:
    """The in-situ means of a trace summary, in µs, as one line."""
    parts = [f"{k} {1e3 * v['mean_ms']:.2f} ({v['launches']})"
             for k, v in summary["kernels"].items()]
    parts += [f"{k} a call {1e3 * v['mean_ms']:.2f} ({v['calls']})"
              for k, v in summary["calls"].items()]
    return "; ".join(parts)


def _device_ops_per_call(fn, calls: int = 5, names=None,
                         traces: int = 5) -> float:
    """Operations (kernels, copies, memsets) that one call of ``fn`` puts on
    the card, counted by torch.profiler over ``calls`` calls; their names
    are added to the set ``names`` where one is given.  The profiler now
    and then drops an event from a trace of short calls (PERF.md §7; B5's
    two kernels once lost one event in each of three traces), which only
    ever lowers a count, so each operation's largest count over ``traces``
    traces is taken, as the card tests' ``_device_ops`` does: an operation
    a wrapper adds shows in some trace, and one it does not add in none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts: dict = {}
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                counts[e.key] = max(counts.get(e.key, 0), e.count)
    if names is not None:
        names.update(counts)
    return sum(counts.values()) / calls


def _at_beam_rows(label: str, step, plain, randn, args, k: int = 4):
    """B4 or B6 (``step``, ``plain`` its plain version) at the rows beam
    search gives it: the main path's cache (``args``: q, k8, v8, k_scale,
    v_scale) tiled per beam as ``runtime.beam`` tiles it
    (``repeat_interleave(k, dim=1)``, scales as the [..., 0, 0] views of a
    [L, B*K, H, 1, 1] tensor), B*K queries.  Each beam's rows must be
    bitwise the kernel's rows on the untiled cache; returns (bf16 steps
    from the plain version, bitwise equal to it, ms a call)."""
    import torch

    q, k8, v8, ks, vs = args
    b, h, dh = q.shape
    s = k8.shape[3]
    tiled = [x.repeat_interleave(k, dim=1) for x in (k8, v8)] + [
        x[..., None, None].repeat_interleave(k, dim=1)[..., 0, 0]
        for x in (ks, vs)]
    qk = randn(b * k, h, dh, scale=0.125)
    got = step(qk, *tiled, 2, s_valid=s)
    for j in range(k):
        rows = torch.arange(b, device=q.device) * k + j
        if not torch.equal(got[rows], step(qk[rows].contiguous(), k8, v8, ks,
                                           vs, 2, s_valid=s)):
            raise AssertionError(f"{label} at {b * k} beam rows: beam {j} is "
                                 "not bitwise its rows on the untiled cache")
    want = plain(qk, *tiled, 2, s_valid=s)
    ms = _median_ms(lambda: step(qk, *tiled, 2, s_valid=s))
    return _bf16_steps(got, want), torch.equal(got, want), ms


def check_b1_b4_edges(card: str, by_name, randn, b1_shape, b4_args) -> None:
    """B1 and B4 beyond the main path's shape, and what their redesign
    promises: B1's second bound (the operations its two-pass contract
    executes: Q.K^T twice, P.V once), B1 at whisper-medium's bucket-1 shape
    and at T = 100; B4 with 6 heads at bucket 1 and with a masked tail; one
    device operation a call of B4's wrapper."""
    import torch

    from whisper_tpu_torch.ops import attention, cross_attention

    b, h, t, dh = b1_shape
    row = by_name["fused_attention"]
    row["two_pass_bound_ms"] = 6 * b * h * t * t * dh / PEAK_OPS["bf16"] * 1e3
    print(f"[kernel] fused_attention: {row['ms']:.4f} ms against the "
          f"function's bound {row['bound_ms']:.5f} ms, the two-pass "
          f"contract's {row['two_pass_bound_ms']:.5f} ms (6 B H T^2 Dh "
          f"operations) and the library call {row['library_ms']:.4f} ms on "
          f"{card}", flush=True)
    for bh, t_ in ((16, 1500), (16, 100)):
        qe, ke, ve = (randn(1, bh, t_, dh, scale=dh ** -0.5),
                      randn(1, bh, t_, dh), randn(1, bh, t_, dh))
        got = attention.fused_attention(qe, ke, ve)
        steps = _bf16_steps(got, attention.fused_attention_plain(qe, ke, ve))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"B1 at B*H = {bh}, T = {t_}: {steps:.3g} "
                                 "bf16 steps from the plain version")
        ms = _median_ms(lambda: attention.fused_attention(qe, ke, ve))
        lib = _median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qe, ke, ve, scale=1.0))
        print(f"[kernel] B1 at B*H = {bh}, T = {t_}: {steps:.3g} bf16 steps; "
              f"{ms:.4f} ms, library call {lib:.4f} ms on {card}", flush=True)

    qx, k8, v8, ks, vs = b4_args
    n_l, _, _, s, _ = k8.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    # bucket 1 with whisper-tiny's 6 heads: a layer's scales off the
    # 16-byte grid; then a cache padded to 1,504 with 1,500 valid columns
    for b_, h_, s_, valid in ((1, 6, s, s), (16, 8, 1504, 1500)):
        k8e = torch.randint(-127, 128, (n_l, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        v8e = torch.randint(-127, 128, (n_l, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        kse = torch.rand(n_l, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        vse = torch.rand(n_l, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        qe = randn(b_, h_, 64, scale=0.125)
        args = (qe, k8e, v8e, kse, vse, 1)
        got = cross_attention.cross_attend_step(*args, s_valid=valid)
        steps = _bf16_steps(got, cross_attention.cross_attend_step_plain(
            *args, s_valid=valid))
        again = cross_attention.cross_attend_step(*args, s_valid=valid)
        if steps > 2.0 or not torch.equal(got, again):
            raise AssertionError(f"B4 at B = {b_}, H = {h_}, S = {s_}, "
                                 f"s_valid = {valid}: {steps:.3g} bf16 steps,"
                                 " or two calls differ")
        ms = _median_ms(lambda: cross_attention.cross_attend_step(
            *args, s_valid=valid))
        cases.append(f"B = {b_}, H = {h_}, S = {s_}/{valid}: {steps:.3g} "
                     f"bf16 steps, {ms:.4f} ms")
    ops = _device_ops_per_call(lambda: cross_attention.cross_attend_step(
        qx, k8, v8, ks, vs, 2, s_valid=s))
    by_name["cross_attend_step"]["device_ops_per_call"] = ops
    if ops != 1.0:
        raise AssertionError(f"B4's wrapper puts {ops} operations on the "
                             "card a call, expected its one kernel")
    # bitwise the plain version only where no 7-bit probability sits on a
    # rounding edge (the path's inputs above); at random queries B4 keeps
    # its 2 bf16 steps, and each beam's rows are bitwise the untiled call's
    steps, bitwise, ms = _at_beam_rows(
        "B4", cross_attention.cross_attend_step,
        cross_attention.cross_attend_step_plain, randn, b4_args)
    if steps > 2.0:
        raise AssertionError(f"B4 at {4 * b4_args[0].shape[0]} beam rows: "
                             f"{steps:.3g} bf16 steps from the plain version")
    cases.append(f"beam rows B*K = {4 * b4_args[0].shape[0]} (the cache "
                 f"tiled per beam): {steps:.3g} bf16 steps, bitwise the plain "
                 f"version {bitwise}, each beam bitwise the untiled call, "
                 f"{ms:.4f} ms")
    print(f"[kernel] B4: {ops:g} device operation a call (torch.profiler); "
          + "; ".join(cases) + f" on {card}", flush=True)


def check_b6_edges(card: str, by_name, randn, b6_args, q_multi) -> None:
    """B6 (B4's cluster of row segments, dequantizing) at the edges its
    segments make: one segment short and exactly one (a cluster of one
    block), one row more, the 1,500 of the path, a masked tail and eleven
    segments (three blocks own two), at bucket 16 with 8 heads and at
    bucket 1 with 6 (a layer's slice of the scales off the 16-byte grid);
    each within 2 bf16 steps of the plain version and two calls bitwise
    equal.  B6's and B7-dq's wrappers each put one operation on the card a
    call."""
    import torch

    from whisper_tpu_torch.ops import cross_attention

    qx, k8, v8, ks, vs = b6_args
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for (b_, h_), (s_, valid) in itertools.product(
            ((16, 8), (1, 6)), ((96, 96), (192, 192), (193, 193), (1500, 1500),
                                (1504, 1500), (2000, 1999))):
        k8e = torch.randint(-127, 128, (2, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        v8e = torch.randint(-127, 128, (2, b_, h_, s_, 64), generator=g,
                            device="cuda", dtype=torch.int8)
        kse = torch.rand(2, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        vse = torch.rand(2, b_, h_, generator=g, device="cuda") * 0.02 + 1e-3
        args = (randn(b_, h_, 64, scale=0.125), k8e, v8e, kse, vse, 1)
        got = cross_attention.cross_attend_step_dequant(*args, s_valid=valid)
        steps = _bf16_steps(
            got, cross_attention.cross_attend_step_dequant_plain(
                *args, s_valid=valid))
        again = cross_attention.cross_attend_step_dequant(*args, s_valid=valid)
        if steps > 2.0 or not torch.equal(got, again):
            raise AssertionError(f"B6 at B = {b_}, H = {h_}, S = {s_}, "
                                 f"s_valid = {valid}: {steps:.3g} bf16 steps,"
                                 " or two calls differ")
        cases.append(f"{b_}x{h_}, S = {s_}/{valid}: {steps:.3g}")
    s = k8.shape[3]
    calls = {"cross_attend_step_dequant":
             lambda: cross_attention.cross_attend_step_dequant(
                 qx, k8, v8, ks, vs, 2, s_valid=s),
             "cross_attend_multi_dequant":
             lambda: cross_attention.cross_attend_multi(
                 q_multi, k8, v8, ks, vs, 2, s_valid=s)}
    for name, call in calls.items():
        ops = _device_ops_per_call(call)
        by_name[name]["device_ops_per_call"] = ops
        if ops != 1.0:
            raise AssertionError(f"{name}'s wrapper puts {ops} operations on "
                                 "the card a call, expected its one kernel")
    # B6 sums its bf16 p.v products in another order than the plain version
    # (0.3 bf16 steps at the path's inputs): its 2 steps, and each beam's
    # rows bitwise the untiled call's
    steps, bitwise, ms = _at_beam_rows(
        "B6", cross_attention.cross_attend_step_dequant,
        cross_attention.cross_attend_step_dequant_plain, randn, b6_args)
    if steps > 2.0:
        raise AssertionError(f"B6 at {4 * b6_args[0].shape[0]} beam rows: "
                             f"{steps:.3g} bf16 steps from the plain version")
    cases.append(f"beam rows B*K = {4 * b6_args[0].shape[0]} (the cache "
                 f"tiled per beam): {steps:.3g}, bitwise the plain version "
                 f"{bitwise}, each beam bitwise the untiled call, {ms:.4f} ms")
    print(f"[kernel] B6 and B7-dq: 1 device operation a call each "
          "(torch.profiler); B6 within 2 bf16 steps, two calls equal, at "
          + "; ".join(cases) + f" (bf16 steps) on {card}", flush=True)


def check_b2_b3_edges(card: str, by_name, randn, mlp_args, med_args,
                      b3_args) -> None:
    """B2 and B3 beyond the main path's shape, and what their redesign
    promises.  B2: 1 row, 1,499 rows (a ragged last tile) and the 24,000 of
    the main path at d = 512, 1,500 rows at d = 1,024 and 1,280; its three
    hand-written kernels and nothing else on the card a call; its time
    beside the bf16 composition of five PyTorch calls.  B3: pos 0, 70 and
    S - 1 with mixed pads, ``pos`` as an int and as a device tensor bitwise
    the same in output and caches; one device operation a call with and
    without ``pad_count``."""
    import torch

    from whisper_tpu_torch.ops import encoder_mlp, self_attention

    cases = []
    for args, n_rows in ((mlp_args, 1), (mlp_args, 1499), (mlp_args, None),
                         (med_args, None)):
        xe = args[0].reshape(1, -1, args[0].shape[-1])
        xe = xe if n_rows is None else xe[:, :n_rows].contiguous()
        got = encoder_mlp.fused_encoder_mlp(xe, *args[1:])
        steps = _bf16_steps(got, encoder_mlp.fused_encoder_mlp_plain(
            xe, *args[1:]))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"B2 at {tuple(xe.shape)}: {steps:.3g} bf16 "
                                 "steps from the plain version")
        cases.append(f"{xe.shape[1]} x {xe.shape[2]}: {steps:.3g}")
    g = torch.Generator(device="cuda").manual_seed(2)
    dl, fl, bf = 1280, 5120, torch.bfloat16
    large = (randn(1, 1500, dl), 1.0 + randn(dl, scale=0.1),
             randn(dl, scale=0.1),
             torch.randint(-127, 128, (dl, fl), generator=g, device="cuda")
             .to(bf) * torch.tensor(2e-4, dtype=bf), randn(fl, scale=0.1),
             torch.randint(-127, 128, (fl, dl), generator=g, device="cuda")
             .to(bf) * torch.tensor(2e-4, dtype=bf), randn(dl, scale=0.1))
    got = encoder_mlp.fused_encoder_mlp(*large)
    steps = _bf16_steps(got, encoder_mlp.fused_encoder_mlp_plain(*large))
    if steps > 2.0:
        raise AssertionError(f"B2 at d = {dl}: {steps:.3g} bf16 steps from "
                             "the plain version")
    large_ms = _median_ms(lambda: encoder_mlp.fused_encoder_mlp(*large))
    cases.append(f"1500 x {dl}: {steps:.3g} ({large_ms:.4f} ms)")
    names = set()
    ops = _device_ops_per_call(
        lambda: encoder_mlp.fused_encoder_mlp(*mlp_args), names=names)
    by_name["fused_encoder_mlp"]["device_ops_per_call"] = ops
    if ops != 3.0 or not all("mlp_ln_kernel" in n or "gemm_kernel" in n
                             for n in names):
        raise AssertionError(f"B2's wrapper puts {ops} operations on the "
                             f"card a call, expected its three kernels: "
                             f"{sorted(names)}")

    for label, args, row in (("d = 512, 24,000 rows", mlp_args,
                              "fused_encoder_mlp"),
                             ("d = 1,024, 1,500 rows", med_args,
                              "fused_encoder_mlp_d1024")):
        comp_ms = _median_ms(lambda: _encoder_mlp_composition(*args))
        peak = by_name[row]["bound_ms"] / by_name[row]["ms"]
        print(f"[kernel] B2 at {label}: {by_name[row]['ms']:.4f} ms "
              f"({100 * peak:.1f}% of the bf16 peak) against a composition "
              f"of five PyTorch calls in bf16 (layer_norm, linear, gelu, "
              f"linear, add; no one call computes B2) {comp_ms:.4f} ms on "
              f"{card}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    encoder_mlp.fused_encoder_mlp(*mlp_args)
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"[kernel] B2: {ops:g} device operations a call, all its own "
          f"kernels; bf16 steps from the plain version at rows x d "
          + ", ".join(cases) + f"; output and scratch of a call at 24,000 "
          f"rows {scratch:.1f} MiB on {card}", flush=True)

    q, kn, vn, kc, vc = b3_args
    n_b, s_max = q.shape[0], kc.shape[3]
    pads = torch.arange(n_b, dtype=torch.int32, device="cuda") % 5
    worst = 0.0
    for pos in (0, 70, s_max - 1):
        pad = torch.clamp(pads * (pos // 4), max=pos).to(torch.int32)
        caches = [[t.clone() for t in (kc, vc)] for _ in range(3)]
        pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
        got = self_attention.self_attend_step(q, kn, vn, *caches[0], 3, pos,
                                              pad)
        got_t = self_attention.self_attend_step(q, kn, vn, *caches[1], 3,
                                                pos_t, pad)
        want = self_attention.self_attend_step_plain(q, kn, vn, *caches[2],
                                                     3, pos, pad)
        steps = _bf16_steps(got, want)
        worst = max(worst, steps)
        same = torch.equal(got, got_t) and all(
            torch.equal(a, b_) and torch.equal(a, c)
            for a, b_, c in zip(*caches))
        if steps > 2.0 or not same:
            raise AssertionError(f"B3 at pos {pos}: {steps:.3g} bf16 steps; "
                                 f"int and device pos and the plain "
                                 f"version's caches bitwise equal: {same}")
    pos_t = torch.tensor([70], dtype=torch.int32, device="cuda")
    zero = torch.zeros(n_b, dtype=torch.int32, device="cuda")
    ops = {_device_ops_per_call(lambda: self_attention.self_attend_step(
        q, kn, vn, kc, vc, 3, p_, pad_))
        for p_ in (70, pos_t) for pad_ in (None, zero)}
    by_name["self_attend_step"]["device_ops_per_call"] = max(ops)
    if ops != {1.0}:
        raise AssertionError(f"B3's wrapper puts {sorted(ops)} operations on "
                             "the card a call, expected its one kernel")
    dev_ms = _median_ms(lambda: self_attention.self_attend_step(
        q, kn, vn, kc, vc, 3, pos_t))
    by_name["self_attend_step"]["device_pos_ms"] = dev_ms
    print(f"[kernel] B3: 1 device operation a call with and without "
          f"pad_count, pos an int or a device tensor; at pos 0, 70, "
          f"{s_max - 1} with mixed pads at most {worst:.3g} bf16 steps from "
          f"the plain version, the two forms of pos bitwise equal in output "
          f"and caches; with pos on the device {dev_ms:.4f} ms a call "
          f"(an int: {by_name['self_attend_step']['ms']:.4f}) on {card}",
          flush=True)


def check_b9_edges(card: str, by_name, randn, qkv_args, qkv_med,
                   out_args) -> None:
    """B9a and B9b (B2's LayerNorm kernel and tiled products under names of
    their own) at the edges of the tiles: B9a at 1 and 1,499 rows and at
    d = 1,280, B9b at 1, 1,499 and 24,000 rows and at d = 128, 384 and 768,
    each within 2 bf16 steps of the plain version; two calls of each
    bitwise equal; B9a puts its two kernels on the card a call and B9b its
    four, each by its name; their times beside the bf16 composition of
    PyTorch calls that computes the same function (no one call does)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.ops import encoder_block as eb

    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def qweight(rows_, cols, s):
        return (torch.randint(-127, 128, (rows_, cols), generator=g,
                              device="cuda").to(bf)
                * torch.tensor(s, dtype=bf))

    def first(a, n_rows):
        return a.reshape(1, -1, a.shape[-1])[:, :n_rows].contiguous()

    cases = []

    def hold(label, call, plain, args):
        got = call(*args)
        steps = _bf16_steps(got, plain(*args))
        if steps > 2.0 or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: {steps:.3g} bf16 steps from the "
                                 "plain version")
        if not torch.equal(got, call(*args)):
            raise AssertionError(f"{label}: two calls differ")
        cases.append(f"{label} {steps:.3g}")

    qkv, out_mlp = (eb.fused_ln_qkv, eb.fused_ln_qkv_plain), \
        (eb.fused_out_mlp, eb.fused_out_mlp_plain)
    for n_rows in (1, 1499, None):
        hold(f"B9a {n_rows or 24000} x 512", *qkv,
             (first(qkv_args[0], n_rows),) + qkv_args[1:])
        hold(f"B9b {n_rows or 24000} x 512", *out_mlp,
             (first(out_args[0], n_rows), first(out_args[1], n_rows))
             + out_args[2:])
    hold("B9a' 1500 x 1024", *qkv, qkv_med)
    dl = 1280
    hold(f"B9a 1500 x {dl}", *qkv,
         (randn(1, 1500, dl), 1.0 + randn(dl, scale=0.1),
          randn(dl, scale=0.1), qweight(dl, 3 * dl, 2e-4),
          randn(3 * dl, scale=0.1)))
    for dw in (128, 384, 768):
        fw = 4 * dw
        hold(f"B9b 1500 x {dw}", *out_mlp,
             (randn(1, 1500, dw), randn(1, 1500, dw), qweight(dw, dw, 3e-4),
              randn(dw, scale=0.1), 1.0 + randn(dw, scale=0.1),
              randn(dw, scale=0.1), qweight(dw, fw, 3e-4),
              randn(fw, scale=0.1), qweight(fw, dw, 3e-4),
              randn(dw, scale=0.1)))

    for row, call, args, want in (
            ("fused_ln_qkv", eb.fused_ln_qkv, qkv_args,
             ("qkv_ln_kernel", "QkvBias")),
            ("fused_ln_qkv_d1024", eb.fused_ln_qkv, qkv_med,
             ("qkv_ln_kernel", "QkvBias")),
            ("fused_out_mlp", eb.fused_out_mlp, out_args,
             ("OutProjResidual", "out_ln_kernel", "OutFc1Gelu",
              "OutFc2Residual"))):
        names = set()
        ops = _device_ops_per_call(lambda: call(*args), names=names)
        by_name[row]["device_ops_per_call"] = ops
        if ops != len(want) or not all(any(fn in n for n in names)
                                       for fn in want):
            raise AssertionError(f"{row}'s wrapper puts {ops} operations on "
                                 f"the card a call, expected its kernels "
                                 f"{want}: {sorted(names)}")

    def out_mlp_composition(x, ctx, o_w, o_b, ln_s, ln_b, w1, b1, w2, b2):
        y = x + F.linear(ctx, o_w.t(), o_b)
        r = F.layer_norm(y, y.shape[-1:], ln_s, ln_b, 1e-5)
        h = F.gelu(F.linear(r, w1.t(), b1), approximate="tanh")
        return y + F.linear(h, w2.t(), b2)

    for row, comp, args, calls in (
            ("fused_ln_qkv", _qkv_composition, qkv_args,
             "layer_norm, linear"),
            ("fused_ln_qkv_d1024", _qkv_composition, qkv_med,
             "layer_norm, linear"),
            ("fused_out_mlp", out_mlp_composition, out_args,
             "linear, add, layer_norm, linear, gelu, linear, add")):
        comp_ms = _median_ms(lambda: comp(*args))
        by_name[row]["composition_ms"] = comp_ms
        peak = by_name[row]["bound_ms"] / by_name[row]["ms"]
        print(f"[kernel] {row}: {by_name[row]['ms']:.4f} ms "
              f"({100 * peak:.1f}% of its bound), "
              f"{by_name[row]['device_ops_per_call']:g} device operations a "
              f"call, against a composition of PyTorch calls in bf16 "
              f"({calls}; no one call computes it) {comp_ms:.4f} ms on "
              f"{card}", flush=True)
    print(f"[kernel] B9a and B9b: bf16 steps from the plain version at rows "
          f"x d: " + "; ".join(cases) + f"; two calls of each bitwise equal "
          f"on {card}", flush=True)


def check_b8_b5_edges(card: str, by_name, randn, b3_args, wire) -> None:
    """B8 and B5 beyond the main path's shape, and what their redesign
    promises.  B8: pos 0, 70 and S - 1 with mixed pads and with none, at
    S = 132, 131 (the scale planes off the 16-byte grid) and 448 (more
    shared memory than a launch gets unasked), ``pos`` as an int and as a
    device tensor: output and the four buffers bitwise equal between the
    two, the buffers bitwise the plain version's, the output within 2 bf16
    steps of it; one device operation a call with and without
    ``pad_count``.  B5: 1, 16, 17, 3,000 and 7,680 valid frames in buckets
    of 3,000 and 12,000, int16 and float32 wires, 80 and 128 mels: within
    1e-4 of the plain version or, where the plain version itself stands
    farther than 1e-4 from its function evaluated in float64 (cuBLAS orders
    its fp32 sums by the shape), within 1e-4 of that; the invalid frames
    exactly 0, two calls bitwise equal, its two kernels and nothing else on
    the card a call; the cuFFT composition's error beside its time."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.ops import log_mel, self_attention
    from whisper_tpu_torch.ops.common import disable_tf32
    from whisper_tpu_torch.profile_ladder import mel_composition

    q, kn, vn, kc, vc = b3_args
    n_b, n_h = q.shape[:2]
    worst = 0.0
    for s_ in (132, 131, 448):
        k8, v8, ks, vs = self_attention.quantize_self_cache(
            randn(2, n_b, n_h, s_, 64), randn(2, n_b, n_h, s_, 64))
        for pos, mixed in itertools.product((0, 70, s_ - 1), (True, False)):
            pad = (torch.clamp(torch.arange(n_b, device="cuda") % 5
                               * (pos // 4), max=pos).to(torch.int32)
                   if mixed else None)
            bufs = [[x.clone() for x in (k8, v8, ks, vs)] for _ in range(3)]
            pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
            got = self_attention.self_attend_step_int8(q, kn, vn, *bufs[0], 1,
                                                       pos, pad)
            got_t = self_attention.self_attend_step_int8(q, kn, vn, *bufs[1],
                                                         1, pos_t, pad)
            want = self_attention.self_attend_step_int8_plain(
                q, kn, vn, *bufs[2], 1, pos, pad)
            steps = _bf16_steps(got, want)
            worst = max(worst, steps)
            same = torch.equal(got, got_t) and all(
                torch.equal(a, b_) and torch.equal(a, c)
                for a, b_, c in zip(*bufs))
            if steps > 2.0 or not same:
                raise AssertionError(
                    f"B8 at S = {s_}, pos {pos}, pads {mixed}: {steps:.3g} "
                    "bf16 steps; int and device pos and the plain version's "
                    f"buffers bitwise equal: {same}")
    i8 = self_attention.quantize_self_cache(kc, vc)
    pos_t = torch.tensor([70], dtype=torch.int32, device="cuda")
    zero = torch.zeros(n_b, dtype=torch.int32, device="cuda")
    ops = {_device_ops_per_call(lambda: self_attention.self_attend_step_int8(
        q, kn, vn, *i8, 3, p_, pad_))
        for p_ in (70, pos_t) for pad_ in (None, zero)}
    by_name["self_attend_step_int8"]["device_ops_per_call"] = max(ops)
    if ops != {1.0}:
        raise AssertionError(f"B8's wrapper puts {sorted(ops)} operations on "
                             "the card a call, expected its one kernel")
    dev_ms = _median_ms(lambda: self_attention.self_attend_step_int8(
        q, kn, vn, *i8, 3, pos_t))
    by_name["self_attend_step_int8"]["device_pos_ms"] = dev_ms
    print(f"[kernel] B8: 1 device operation a call with and without "
          f"pad_count, pos an int or a device tensor; at S = 132, 131, 448 "
          f"and pos 0, 70, S - 1, mixed pads and none, at most {worst:.3g} "
          f"bf16 steps from the plain version, the four buffers bitwise its "
          f"own, the two forms of pos bitwise equal; with pos on the device "
          f"{dev_ms:.4f} ms a call (an int: "
          f"{by_name['self_attend_step_int8']['ms']:.4f}) on {card}",
          flush=True)

    disable_tf32()
    rng = np.random.default_rng(4)
    worst, cases, by_float64 = 0.0, 0, []
    for (valid, n_frames), n_mels, form in itertools.product(
            ((1, 3000), (16, 3000), (17, 3000), (3000, 3000), (1, 12000),
             (16, 12000), (17, 12000), (3000, 12000), (7680, 12000)),
            (80, 128), ("int16", "float32")):
        n = valid * golden.HOP
        t_ = np.arange(n) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 440 * t_)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        padded = golden.reflect_pad(audio)
        if form == "int16":
            padded = np.round(np.clip(padded, -1, 1) * 32767).astype(np.int16)
        x = torch.from_numpy(padded).cuda()
        got = log_mel.log_mel(x, valid, n_mels, n_frames)
        again = log_mel.log_mel(x, valid, n_mels, n_frames)
        want = log_mel.log_mel_plain(x, valid, n_mels, n_frames)
        exact = log_mel.log_mel_float64(x, valid, n_mels, n_frames)
        err, err64, plain64 = (float((a - b).abs().max())
                               for a, b in ((got, want), (got, exact),
                                            (want, exact)))
        label = f"{valid} of {n_frames} frames, {n_mels} mels, {form}"
        if err > 1e-4 and plain64 > 1e-4:
            by_float64.append(f"{label}: {err:.3g} from the plain version, "
                              f"which is {plain64:.3g} from float64; "
                              f"{err64:.3g} from float64")
            err = err64
        worst = max(worst, err)
        if (err > 1e-4 or not torch.equal(got, again)
                or not bool((got[:, valid:] == 0).all())):
            raise AssertionError(
                f"B5 at {label}: {err:.3g} from the plain version (tolerance "
                f"1e-4; the plain version {plain64:.3g} from float64), two "
                f"calls bitwise {torch.equal(got, again)}")
        cases += 1
        if valid in (1, 7680):
            names = set()
            ops = _device_ops_per_call(
                lambda: log_mel.log_mel(x, valid, n_mels, n_frames),
                names=names)
            if ops != 2.0 or not all(
                    any(k in n_ for n_ in names)
                    for k in ("mel_spectrum_kernel", "mel_normalize_kernel")):
                raise AssertionError(f"B5's wrapper puts {ops} operations on "
                                     f"the card a call: {sorted(names)}")
    by_name["log_mel"]["device_ops_per_call"] = 2.0
    nv, nf = 7680, 12000
    comp_err = float((mel_composition(wire, nv, 80, nf)
                      - log_mel.log_mel_plain(wire, nv, 80, nf)).abs().max())
    row = by_name["log_mel"]
    row["library_err"] = comp_err
    print(f"[kernel] B5: 2 device operations a call (its two kernels); "
          f"within {worst:.3g} of the plain version at {cases} cases (1, 16, "
          f"17, 3,000, 7,680 valid frames in buckets of 3,000 and 12,000, "
          f"int16 and float32, 80 and 128 mels; held against float64 where "
          f"the plain version is out: {by_float64 or 'none'}), invalid "
          f"frames 0, two calls bitwise equal; at 7,680 of 12,000 frames "
          f"{row['ms']:.4f} ms "
          f"against the composition around torch.stft {row['library_ms']:.4f}"
          f" ms (its error against the plain version {comp_err:.3g}) on "
          f"{card}", flush=True)


# The kernels of the headline main path (x5, a 301.574 s file: streamed
# mel, so no B5; int8 x int8 cross-attention, so no B6), and the greedy
# step's tail; C, ahead of the decode's while node, is read on its own
# (GRAPHED_ONLY).
MAIN_PATH_KERNELS = ("fused_attention", "fused_encoder_mlp",
                     "self_attend_step", "cross_attend_step", "loop_tail")
# Launched by a graphed loop alone (the eager loop reads ``done`` on the
# host in its place), so left out of the counts that graphed and eager runs
# compare: the while node's condition kernel.
GRAPHED_ONLY = ("while_condition",)


def _memory_line(label: str) -> None:
    """The device memory a phase starts with, earlier phases' garbage
    collected and the allocator's free cache returned: bytes allocated and
    reserved, and the decode graphs still alive (``DecodeGraphs``: their
    keys and the bytes they count)."""
    import gc

    import torch

    from whisper_tpu_torch.runtime.generate import DecodeGraphs

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = [o for o in gc.get_objects() if isinstance(o, DecodeGraphs)]
    gib = 2**-30
    print(f"[memory] before {label}: allocated "
          f"{torch.cuda.memory_allocated() * gib:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() * gib:.3f} GiB; {len(live)} decode "
          f"graphs alive, {sum(len(g.kept()) for g in live)} keys counting "
          f"{sum(g.nbytes() for g in live) * gib:.3f} GiB", flush=True)


def _counts(results) -> dict:
    """Every kernel's count but ``GRAPHED_ONLY``'s, once the launches of
    the graphs' bodies that ran are added (``ops.common.settle_launches``:
    a graphed decode loop's bodies count where the results reach the
    host)."""
    from whisper_tpu_torch.ops.common import settle_launches

    settle_launches(wait=True)
    return {r["name"]: getattr(*r["counter"]) for r in results
            if r["name"] not in GRAPHED_ONLY}


def _condition_count() -> int:
    """C's launches since the counts were set to 0, the graphs' bodies
    that ran added."""
    from whisper_tpu_torch.ops import loop_tail
    from whisper_tpu_torch.ops.common import settle_launches

    settle_launches(wait=True)
    return loop_tail.condition_launches


def _zero_counts(results) -> None:
    """Set every kernel's count to 0, earlier runs' graph bodies added
    first (so none of them lands in the next count)."""
    from whisper_tpu_torch.ops.common import settle_launches

    settle_launches(wait=True)
    for r in results:
        setattr(*r["counter"], 0)


def check_against_cpu(params, dims, model_id: str = "openai/whisper-base",
                      seconds: float = 80.0, steps: int = 12,
                      enc_steps_tol: float = 8.0, logit_tol: float = 5e-2,
                      card_session=None) -> None:
    """The port on the card (kernels) against the port on the CPU (plain
    versions) at ``model_id`` (``dims``, weights ``params``) on a clip of
    ``seconds``: mel, encoder states, prefill logits and ``steps`` decode
    steps teacher-forced with the CPU's tokens, the prompt the default
    special ids (en, transcribe, no timestamps).  Tolerances: the mel 1e-4,
    the encoder ``enc_steps_tol`` bf16 steps, the logits ``logit_tol``.
    ``card_session``: the x5 session on the card to use, where the caller
    has one."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    audio = synth_audio(seconds)
    padded = golden.reflect_pad(audio)
    nv = golden.num_frames(len(audio))
    sessions = {"cuda": card_session or make_session("cuda", params,
                                                     model_id=model_id),
                "cpu": make_session("cpu", params, model_id=model_id)}
    mels, enc, cpu_s = {}, {}, {}
    for dev, s in sessions.items():
        t0 = time.perf_counter()
        mels[dev] = s.compute_mel(padded, nv,
                                  mel_frame_bucket(nv)).float().cpu()
        cpu_s["mel"] = time.perf_counter() - t0      # the CPU's: last
    mel_err = float((mels["cuda"] - mels["cpu"]).abs().max())
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    chunks = torch.stack([torch.nn.functional.pad(
        mels["cpu"], (0, CHUNK_FRAMES))[:, s:s + CHUNK_FRAMES]
        for s in starts])
    for dev, s in sessions.items():
        t0 = time.perf_counter()
        enc[dev] = s.encoder(chunks.to(dev))
        cpu_s["encoder"] = time.perf_counter() - t0    # the CPU's: last
    enc_steps = _bf16_steps(enc["cuda"].cpu(), enc["cpu"])
    finite = bool(torch.isfinite(enc["cuda"]).all())

    special = special_tokens("en", "transcribe", None)
    prompt = torch.tensor([special.sot, special.lang, special.task,
                           special.no_timestamps])
    tokens = prompt[None].expand(len(starts), -1)
    p_len = len(prompt)
    logits, caches = {}, {}
    for dev, s in sessions.items():
        p = s._decoder_params
        logits[dev], caches[dev] = whisper.decoder_prefill(
            p, dims, tokens.to(dev), enc["cpu"].to(dev), p_len + steps,
            int8_cross_kv=True)
    finite &= bool(torch.isfinite(logits["cuda"]).all())
    errs = [float((logits["cuda"].cpu() - logits["cpu"]).abs().max())]
    last = logits["cpu"][:, -1].argmax(-1)
    for i in range(steps):
        step = {}
        for dev, s in sessions.items():
            step[dev], caches[dev] = whisper.decoder_step(
                s._decoder_params, dims, last.to(dev), p_len + i,
                caches[dev], kernel_step=True,
                cross_len=enc["cpu"].shape[1])
        if not torch.isfinite(step["cuda"]).all():
            raise AssertionError(f"non-finite logits at step {i}")
        errs.append(float((step["cuda"].cpu() - step["cpu"]).abs().max()))
        last = step["cpu"].argmax(-1)
    scale = float(logits["cpu"].abs().max())
    name = model_id.split("/")[-1]
    print(f"[reference] {name}: card vs CPU on a {seconds:g} s clip "
          f"({len(starts)} chunk(s), {dims.n_mels} mels, "
          f"{dims.encoder_layers} encoder layers, {dims.vocab_size} ids): "
          f"mel max diff {mel_err:.3g}; encoder {enc_steps:.2f} bf16 steps; "
          f"logits max diff prefill {errs[0]:.3g}, {steps} steps "
          f"{max(errs[1:]):.3g} (logit scale {scale:.3g}); the CPU's mel "
          f"{cpu_s['mel']:.1f} s, encoder "
          f"{cpu_s['encoder']:.1f} s", flush=True)
    if not finite:
        raise AssertionError(f"{name}: non-finite encoder states or logits "
                             "on the card")
    if mel_err > 1e-4:
        raise AssertionError(f"mel differs by {mel_err} (tolerance 1e-4)")
    if enc_steps > enc_steps_tol:
        raise AssertionError(f"encoder differs by {enc_steps:.2f} bf16 "
                             f"steps (tolerance {enc_steps_tol:g})")
    if max(errs) > logit_tol:
        raise AssertionError(f"logits differ by {max(errs)} (tolerance "
                             f"{logit_tol:g})")


def _bucket_encoder_states(session, audio):
    """Encoder states of the file's chunk bucket (the 301.574 s file: 12
    chunks in a bucket of 16, the padding rows slicing zeros), and a prompt
    row (en, transcribe, no timestamps) for each."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )

    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    starts += [mel.shape[1]] * (session._batch_bucket(len(starts))
                                - len(starts))
    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    enc = session.encoder(torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                                       for s in starts]))
    prompt = torch.tensor([[50258, 50259, 50359, 50363]] * len(starts),
                          device=enc.device)
    return enc, prompt


def check_main_path_finite(session, audio, dims) -> None:
    """The main path's encoder states and prefill logits for the file's
    chunk bucket are finite."""
    import torch

    from whisper_tpu_torch.models import whisper

    enc, prompt = _bucket_encoder_states(session, audio)
    logits, _ = whisper.decoder_prefill(session._decoder_params, dims, prompt,
                                        enc, 4 + 128, int8_cross_kv=True)
    if not (torch.isfinite(enc).all() and torch.isfinite(logits).all()):
        raise AssertionError("non-finite encoder states or logits on the "
                             "main path")


def _timed_run(session, audio, results, max_new_tokens: int = 128,
               runs: int = 1, **decode):
    """A warm-up, then ``runs`` runs, each with every kernel's count set to
    0 just before it and read just after; the runs must give equal tokens
    and counts.  ``decode``: run_once's decoding options (speculative,
    draft_k).  The median run by e2e: (e2e s, Timing, tokens, counts)."""
    import torch

    from whisper_tpu_torch.headline import run_once

    run_once(session, audio, max_new_tokens=max_new_tokens, **decode)
    out = []
    for _ in range(runs):
        _zero_counts(results)
        collector = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, timing = run_once(session, audio, token_collector=collector,
                             max_new_tokens=max_new_tokens, **decode)
        out.append((time.perf_counter() - t0, timing, collector[0],
                    _counts(results)))
        if not ((out[-1][2] == out[0][2]).all() and out[-1][3] == out[0][3]):
            raise AssertionError("two runs gave different tokens or launches")
    return sorted(out, key=lambda r: r[0])[len(out) // 2]


def check_ladder(card: str, results, params, dims, audio, x5) -> dict:
    """The 301.574 s file at whisper-base through x7, x6 and x5 with the
    fused encoder block and the hybrid decode step; ``x5``: (e2e, Timing,
    tokens, counts) of the main path's run, printed beside each.  Returns
    each configuration's (e2e, Timing, tokens, counts)."""
    import warnings

    from whisper_tpu_torch.headline import make_session

    n_l, n_e = dims.decoder_layers, dims.encoder_layers
    configs = (("x7", "x7", {}),
               ("x6", "x6", {}),
               ("x5+fused_encoder_block+fused_decoder_step", "x5",
                dict(fused_encoder_block=True, fused_decoder_step=True)))
    runs = {"x5": x5}
    for label, variant, overrides in configs:
        with warnings.catch_warnings():
            # x6: "fused_encoder_mlp overrides int8_encoder_act ..."
            warnings.simplefilter("ignore", UserWarning)
            session = make_session("cuda", params, variant, **overrides)
        e2e, timing, toks, c = _timed_run(session, audio, results)
        runs[label] = (e2e, timing, toks, c)
        if toks.shape != x5[2].shape:
            raise AssertionError(f"{label}: tokens {toks.shape}")
        if not ((toks >= 0) & (toks < dims.vocab_size)).all():
            raise AssertionError(f"{label}: token ids outside the vocabulary")
        check_main_path_finite(session, audio, dims)
        enc = (c["fused_attention"], c["fused_encoder_mlp"],
               c["fused_ln_qkv"], c["fused_out_mlp"])
        step = (c["self_attend_step"], c["self_attend_step_int8"],
                c["cross_attend_step"], c["decoder_mlp_block"])
        layers_steps = max(step)
        # the tail once a step
        ok = layers_steps > 0 and layers_steps % n_l == 0 \
            and c["cross_attend_step_dequant"] == 0 \
            and c["loop_tail"] * n_l == layers_steps
        if label == "x7":      # B8 then B4, once per layer and step; no B3
            ok = ok and enc == (n_e, n_e, 0, 0) \
                and step == (0, layers_steps, layers_steps, 0)
        elif label == "x6":    # the kernels of x5
            ok = ok and enc == (n_e, n_e, 0, 0) \
                and step == (layers_steps, 0, layers_steps, 0)
        else:                  # B9a, B1, B9b per encoder layer; B10c per step
            ok = ok and enc == (n_e, 0, n_e, n_e) \
                and step == (0, 0, 0, layers_steps)
        if not ok:
            raise AssertionError(f"{label}: launches {c}")
        del session
    # x7 shares x5's prefill, so every chunk's first token is x5's; after
    # that a flipped near-tie (random weights) carries to the chunk's end.
    if not (runs["x7"][2][:, 0] == x5[2][:, 0]).all():
        raise AssertionError("x7: a first token differs from x5's")
    same = float((runs["x7"][2] == x5[2]).mean())
    print(f"[ladder] x7 tokens equal to x5's: {same:.4f} of "
          f"{x5[2].size}", flush=True)
    for label, (e2e, timing, _, c) in runs.items():
        steps = max(c["cross_attend_step"], c["decoder_mlp_block"]) // n_l
        print(f"[ladder] whisper-base {label}, {len(audio) / 16000:.3f} s, "
              f"on {card}: e2e {e2e:.4f} s, model {timing.model_only_s:.4f} "
              f"s, preprocess {timing.preprocess_s:.4f} s, {steps} decode "
              f"steps (x5: median of 3 runs, the others one run); launches "
              f"{c}", flush=True)
    return runs


def check_speculative(card: str, results, params, dims, audio, x5) -> dict:
    """Speculative decoding of the 301.574 s file (one bucket of 16, 128
    tokens, draft_k = 4): x5 with a random whisper-tiny draft, x5 with
    whisper-base as its own draft on the shared encoder, x4 with the tiny
    draft; ``x5``: (e2e, Timing, tokens, counts) of the greedy main path's
    run.  Returns the launch counts of the x5 and the x4 run with the tiny
    draft, and for each of the two its (greedy tokens, speculative
    tokens)."""
    import numpy as np

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.variants.quant import quantize_params

    n_l, k = dims.decoder_layers, 4
    tiny = get_dims("openai/whisper-tiny")
    tiny_params = init_params(tiny, seed=1)

    def run(label, variant, draft, draft_dims, share, greedy):
        session = make_session("cuda", params, variant)
        if greedy is None:      # this rung's greedy run, for comparison
            greedy = _timed_run(session, audio, results)
        session.set_draft_model(draft, draft_dims, share_encoder=share)
        e2e, timing, toks, c = _timed_run(session, audio, results,
                                          speculative=True, draft_k=k)
        rounds = int(sum(r for r, _ in session.speculative_stats))
        committed = np.concatenate(
            [n.cpu().numpy() for _, n in session.speculative_stats])
        if toks.shape != greedy[2].shape or not (
                (toks >= 0) & (toks < dims.vocab_size)).all():
            raise AssertionError(f"{label}: tokens {toks.shape}")
        # B7 once a layer and round run; the rounds run as the body of a
        # graph's while node that stops on the card where the last row
        # ends, so every round run is counted
        b7 = c["cross_attend_multi"]           # either B7 kernel
        ran = b7 // n_l
        if b7 != ran * n_l or not 1 <= rounds == ran:
            raise AssertionError(f"{label}: B7 launched {b7} times for "
                                 f"{rounds} rounds of {n_l} layers")
        if c["self_attend_step"] or c["self_attend_step_int8"] \
                or c["loop_tail"]:
            raise AssertionError(f"{label}: B3/B8 or the greedy tail "
                                 f"launched: {c}")
        # The prefill is the greedy run's, so every chunk's first token is.
        if not (toks[:, 0] == greedy[2][:, 0]).all():
            raise AssertionError(f"{label}: a first token differs from the "
                                 "greedy run's")
        same = float((toks == greedy[2]).mean())
        print(f"[speculative] whisper-base {label}, draft_k {k}, on {card}: "
              f"e2e {e2e:.4f} s, model {timing.model_only_s:.4f} s (greedy "
              f"{greedy[0]:.4f} / {greedy[1].model_only_s:.4f} s); {rounds} "
              f"verify rounds ({ran} run, graphed), "
              f"{committed.sum() / rounds / len(committed):.3f}"
              f" tokens committed per round and row; tokens equal to the "
              f"greedy run's: {same:.4f} of {toks.size}; launches {c}",
              flush=True)
        return toks, rounds, c, greedy

    adv, _, c5, _ = run("x5 + whisper-tiny draft", "x5", tiny_params, tiny,
                     False, x5)
    if not (c5["cross_attend_step"] > 0
            and c5["cross_attend_step_dequant"] == 0):
        raise AssertionError(f"x5 draft steps: launches {c5}")
    # the main model's own int8 weights, so that draft and main differ only
    # in the shape of their passes (one token against five)
    own, rounds, _, _ = run("x5 + its own weights as draft, shared encoder",
                         "x5", quantize_params(params), dims, True, x5)
    # One run rejects nearly every proposal, the other accepts nearly all:
    # the committed sequence must not depend on the draft.
    if not (adv == own).all():
        raise AssertionError(
            "speculative tokens depend on the draft: "
            f"{float((adv == own).mean()):.4f} equal")
    if rounds > 2 * -(-128 // (k + 1)):
        raise AssertionError(f"own-weights draft: {rounds} rounds, expected "
                             f"about {-(-128 // (k + 1))}")
    spec4, _, c4, greedy4 = run("x4 + whisper-tiny draft", "x4", tiny_params,
                                tiny, False, None)
    if not (c4["cross_attend_step_dequant"] > 0
            and c4["cross_attend_step"] == 0):
        raise AssertionError(f"x4 draft steps: launches {c4}")
    return {"x5": c5, "x4": c4}, {"x5": (x5[2], adv),
                                  "x4": (greedy4[2], spec4)}


def check_fused_step(card: str, results, params, dims, audio) -> dict:
    """``decoder_step_fused`` (B10a, B10b, B10c per layer) driven greedily
    for 127 steps at whisper-base from a bf16 prefill of the 301.574 s
    file's bucket of 16, eagerly and replayed from one captured CUDA graph
    of a step (token and ``pos`` on the card, advanced inside the graph);
    its time per step beside the x5 kernel step's and the hybrid step's
    over the same 127 steps.  Returns the launch counts of one eager run
    and the replayed step's ms (the faster of two runs)."""
    import torch

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.ops import decoder_kernels as dk

    session = make_session("cuda", params)
    p = session._decoder_params
    enc, prompt = _bucket_encoder_states(session, audio)
    n_p, n_new = prompt.shape[1], 128
    sw = dk.build_step_weights(p, dims)

    def prefill(int8):
        logits, cache = whisper.decoder_prefill(p, dims, prompt, enc,
                                                n_p + n_new,
                                                int8_cross_kv=int8)
        return logits[:, -1].argmax(-1), cache

    def loop(step, first):
        """127 greedy steps without a host sync: (tokens, ms per step)."""
        toks, last = [first], first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n_new):
            last = step(last, n_p + i - 1).argmax(-1)
            toks.append(last)
        torch.cuda.synchronize()
        return (torch.stack(toks, 1),
                (time.perf_counter() - t0) * 1e3 / (n_new - 1))

    def fused_setup():
        first, cache = prefill(False)
        k_tm = dk.cache_to_time_major(cache.self_k)
        v_tm = dk.cache_to_time_major(cache.self_v)

        def step(tok, pos):
            return dk.decoder_step_fused(p, sw, dims, tok, pos, k_tm, v_tm,
                                         cache.cross_k, cache.cross_v)[0]

        return first, cache, k_tm, v_tm, step

    def fused_run():
        first, cache, k_tm, v_tm, step = fused_setup()
        # the first step against the port's plain step on the same cache
        plain_cache = cache._replace(self_k=cache.self_k.clone(),
                                     self_v=cache.self_v.clone())
        want, _ = whisper.decoder_step(p, dims, first, n_p, plain_cache)
        k0, v0 = k_tm.clone(), v_tm.clone()
        got = dk.decoder_step_fused(p, sw, dims, first, n_p, k0, v0,
                                    cache.cross_k, cache.cross_v)[0]
        err = float((got - want).abs().max())
        _zero_counts(results)
        toks, ms = loop(step, first)
        return toks, ms, err, _counts(results)

    def graph_run():
        """The 127 steps replayed from one graph of a step: (tokens, ms per
        step on the host clock, one sync at the end)."""
        first, cache, k_tm, v_tm, _ = fused_setup()
        saved = (k_tm.clone(), v_tm.clone())
        tok = first.clone()
        pos_t = torch.tensor([n_p], dtype=torch.int32, device="cuda")
        toks = torch.zeros((first.shape[0], n_new), dtype=first.dtype,
                           device="cuda")

        def step():
            logits = dk.decoder_step_fused(p, sw, dims, tok, pos_t, k_tm,
                                           v_tm, cache.cross_k,
                                           cache.cross_v)[0]
            tok.copy_(logits.argmax(-1))
            toks.index_copy_(1, (pos_t - (n_p - 1)).long(), tok[:, None])
            pos_t.add_(1)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()                   # warm before the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for buf, s_ in zip((k_tm, v_tm), saved):
            buf.copy_(s_)
        tok.copy_(first)
        pos_t.fill_(n_p)
        toks[:, 0] = first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            graph.replay()
        torch.cuda.synchronize()
        return toks, (time.perf_counter() - t0) * 1e3 / (n_new - 1)

    fused_run()                                   # warm-up
    toks, ms, err, c = fused_run()
    toks2, ms2, _, c2 = fused_run()
    graph_run()                                   # warm-up
    g_toks, g_ms = graph_run()
    g_toks2, g_ms2 = graph_run()
    first, _, _, _, step = fused_setup()
    traced = _traced(lambda: loop(step, first))
    n_steps = (n_new - 1) * dims.decoder_layers
    step_ms = traced["device_busy_ms"] / (n_new - 1)
    print(f"[fused step] in situ over 127 traced eager steps, µs "
          f"(launches): {_in_situ(traced)}; {traced['device_ops']} device "
          f"operations, busy {traced['device_busy_ms']:.2f} ms = "
          f"{step_ms:.4f} ms of device time a step on {card}", flush=True)
    if err > 5e-2:
        raise AssertionError(f"fused step: first-step logits differ from "
                             f"decoder_step's by {err} (tolerance 5e-2)")
    if not ((toks >= 0) & (toks < dims.vocab_size)).all() \
            or not torch.equal(toks, toks2):
        raise AssertionError("fused step: tokens outside the vocabulary or "
                             "not repeatable")
    if not (torch.equal(g_toks, toks) and torch.equal(g_toks2, toks)):
        raise AssertionError("fused step: the tokens replayed from a CUDA "
                             "graph differ from the eager loop's")
    if not (c["decoder_self_block"] == c["decoder_cross_block"]
            == c["decoder_mlp_block"] == n_steps and c == c2):
        raise AssertionError(f"fused step: launches {c}, expected {n_steps} "
                             "of B10a, B10b and B10c")
    if any(v for k_, v in c.items() if k_ not in (
            "decoder_self_block", "decoder_cross_block",
            "decoder_mlp_block")):
        raise AssertionError(f"fused step: other kernels launched: {c}")

    first8, cache8 = prefill(True)

    def x5_step(tok, pos):
        return whisper.decoder_step(p, dims, tok, pos, cache8,
                                    kernel_step=True,
                                    cross_len=enc.shape[1])[0]

    loop(x5_step, first8)
    _, x5_ms = loop(x5_step, first8)
    first16, cache16 = prefill(False)

    def hybrid_step(tok, pos):
        return dk.decoder_step_hybrid(p, sw, dims, tok, pos, cache16)[0]

    loop(hybrid_step, first16)
    _, hybrid_ms = loop(hybrid_step, first16)
    print(f"[fused step] whisper-base, bucket {enc.shape[0]}, 127 steps from "
          f"a bf16 prefill, on {card}: eager {ms:.4f} and {ms2:.4f} ms a "
          f"step (host clock, one sync at the end), replayed from one CUDA "
          f"graph of a step {g_ms:.4f} and {g_ms2:.4f} ms a step (tokens "
          f"equal to the eager loop's), against the x5 kernel step "
          f"{x5_ms:.4f} ms and the hybrid step {hybrid_ms:.4f} ms; device "
          f"time {step_ms:.4f} ms a step; first-step logits within "
          f"{err:.3g} of decoder_step's; tokens equal across two runs; "
          f"launches {c}", flush=True)
    return c, min(g_ms, g_ms2)


@contextlib.contextmanager
def _graph_launches():
    """Within the block every launch of a CUDA graph (``CUDAGraph.replay``)
    adds its host ms to the list yielded: a graphed decode is one launch."""
    import torch

    launches = []
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        t0 = time.perf_counter()
        replay(graph)
        launches.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.CUDAGraph.replay = counted
    try:
        yield launches
    finally:
        torch.cuda.CUDAGraph.replay = replay


@contextlib.contextmanager
def _eager_loop(session):
    """Within the block ``session``'s decode loops (greedy, beams,
    speculative rounds) run their in-place step eagerly on the card
    (``eager=True``), not from their CUDA graphs, reading ``done`` once a
    step (round): where the JAX ``while_loop`` and the graphed loops
    stop."""
    session.eager_decode = True
    try:
        yield
    finally:
        session.eager_decode = False


# [graph] (b): label, variant, RuntimeCfg overrides, decode options
GRAPH_CONFIGS = (
    ("x3 (plain step)", "x3", {}, {}),
    ("x4", "x4", {}, {}),
    ("x5", "x5", {}, {}),
    ("x7", "x7", {}, {}),
    ("x5+fused_encoder_block+fused_decoder_step", "x5",
     dict(fused_encoder_block=True, fused_decoder_step=True), {}),
    ("x5 with the grammar", "x5", {}, {"grammar": True}),
    ("x5, 68-slot prompt left-padded (B3 with pad_count)", "x5", {},
     {"pads": True}),
    ("x7, 68-slot prompt left-padded (B8 with pad_count)", "x7", {},
     {"pads": True}),
    ("x5 at T = 0.5, seed 3, with scores", "x5", {}, {"temperature": 0.5}),
)


def check_graph(card: str, results, params, dims, audio, x5,
                fused_ms: float) -> dict:
    """The greedy loop run from CUDA graphs against the same loop run
    eagerly (``[graph]`` lines), whisper-base, the 301.574 s file, 128
    tokens: (a) the main path (x5), graphed and eager alternated, three runs
    each after a warm-up of each: tokens bitwise and launches equal, e2e
    (median) and ms a step of the bucket's decode (host clock, one sync at
    the end, the prefill's time taken out) beside the fully fused step's
    replay; (b) the bucket of 16 through ``session._greedy`` graphed (the
    capture's call and a later one) and eagerly at x3, x4, x5, x7, both fused
    flags, the grammar, left-padded prompts through B3 and B8, and sampling
    at T = 0.5 with scores (the key in the loop's state, so the graphed
    draws are the eager loop's): tokens (and scores) bitwise, every
    kernel's launches equal, one graph launch a call; (c) the host seconds
    until ``transcribe_from_mel_async`` returns beside the host seconds to
    queue the encoder alone and against the card's span of the work it
    queued (CUDA events), one graph launch a call, and the
    sequential mode's windows graphed (bucket 1, the grammar, pad_count);
    (d) each key's capture seconds; the device memory an x5 session keeps
    (``memory_allocated()`` after its run, less before the session, and
    the peak) run eagerly and then graphed; and, in a fresh x5 session,
    what it keeps as keys add up: the buckets 1-16 warmed, the fallback
    ladder's temperatures with scores at each bucket (every T > 0 one key),
    four prompt lengths at bucket 1, beside the state its graphs count.
    Returns the launch counts of the sampled decode's graphed run (its
    path: the only one that launches the pick kernel)."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, run_once, synth_audio
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.pipeline.sequential import transcribe_sequential
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    t_phase = time.perf_counter()
    special = special_tokens("en", "transcribe", None)
    eot = special.eot
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    gen_cfg = GenerationCfg()
    captures = {}     # GraphKey -> (the label that first ran it, seconds)

    def note(label, s_):
        for k, secs in s_.graphs.captures().items():
            captures.setdefault(k, (label, secs))

    # (d) memory: a fresh x5 session, eager then graphed
    def kept(base):
        gc.collect()                 # what earlier work left in cycles
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - base

    torch.cuda.empty_cache()
    base_mem = kept(0)
    session = make_session("cuda", params, "x5")
    weights_mem = kept(base_mem)
    torch.cuda.reset_peak_memory_stats()
    with _eager_loop(session):
        run_once(session, audio)
    eager_mem = (kept(base_mem), torch.cuda.max_memory_allocated() - base_mem)
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    run_once(session, audio)                      # captures the bucket's key
    graph_mem = (kept(base_mem), torch.cuda.max_memory_allocated() - base_mem,
                 session.graphs.nbytes(), sum(session.graphs.pools().values()),
                 torch.cuda.memory_reserved() - reserved)
    note("x5 main path", session)

    # (a) the main path, alternated
    runs = {"graphed": [], "eager": []}
    for _ in range(3):
        for mode in ("graphed", "eager"):
            _zero_counts(results)
            collector = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                with _eager_loop(session):
                    run_once(session, audio, token_collector=collector)
            else:
                run_once(session, audio, token_collector=collector)
            runs[mode].append((time.perf_counter() - t0, collector[0],
                               _counts(results)))
    want = x5[3]
    for mode, rs in runs.items():
        for e2e, toks, c in rs:
            if not np.array_equal(toks, x5[2]):
                raise AssertionError(f"(a) {mode}: tokens differ from the "
                                     "main path's")
            if c != want:
                raise AssertionError(f"(a) {mode}: launches {c}, the main "
                                     f"path's {want}")
    e2e = {m: statistics.median(r[0] for r in rs) for m, rs in runs.items()}

    enc, _ = _bucket_encoder_states(session, audio)
    masks = session._get_masks(gen_cfg.suppress_tokens,
                               gen_cfg.begin_suppress_tokens)
    prompt_t = torch.tensor(prompt, device="cuda")

    enc1 = enc[:1].contiguous()

    def decode_s(n_new, eager=False, states=enc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eager:
            with _eager_loop(session):
                session._greedy(states, prompt_t, *masks, n_new, eot,
                                early_exit=False)
        else:
            session._greedy(states, prompt_t, *masks, n_new, eot,
                            early_exit=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step_ms, decode_ms = {}, {}
    for name, eager, states in (("graphed", False, enc), ("eager", True, enc),
                                ("graphed, bucket 1", False, enc1)):
        for n_new in (1, 128):
            decode_s(n_new, eager, states)        # warm (and capture)
        prefill = statistics.median(decode_s(1, eager, states)
                                    for _ in range(3))
        whole = statistics.median(decode_s(128, eager, states)
                                  for _ in range(3))
        step_ms[name] = (whole - prefill) * 1e3 / 127
        decode_ms[name] = whole * 1e3
    print(f"[graph] (a) whisper-base x5, {len(audio) / 16000:.3f} s, on "
          f"{card}: e2e graphed {e2e['graphed']:.4f} s "
          f"({[round(r[0], 4) for r in runs['graphed']]}), eager "
          f"{e2e['eager']:.4f} s ({[round(r[0], 4) for r in runs['eager']]}),"
          f" alternated, median of 3; tokens bitwise equal, launches equal "
          f"{want}; the bucket of {enc.shape[0]}'s decode: "
          f"{step_ms['graphed']:.4f} ms a step graphed, "
          f"{step_ms['eager']:.4f} eager (host clock, one sync at the end, "
          f"prefill taken out), the fully fused step replayed "
          f"{fused_ms:.4f}; a lone request's decode (bucket 1, 128 tokens, "
          f"no read) {decode_ms['graphed, bucket 1']:.4f} ms, "
          f"{step_ms['graphed, bucket 1']:.4f} ms a step graphed", flush=True)

    # (b) graphed against eager, configuration by configuration
    rng = np.random.default_rng(17)
    prev = [special.sot_prev] + rng.integers(220, 50000, 63).tolist()
    ts_cfg = TimestampCfg(special.no_timestamps + 1, eot,
                          special.no_timestamps)
    sessions = {("x5", ()): (session, enc)}
    for label, variant, overrides, opts in GRAPH_CONFIGS:
        key = (variant, tuple(sorted(overrides.items())))
        if key not in sessions:
            s_ = make_session("cuda", params, variant, **overrides)
            sessions[key] = (s_, _bucket_encoder_states(s_, audio)[0])
        s_, enc_ = sessions[key]
        b = enc_.shape[0]
        kw, row_prompt = {}, prompt
        if opts.get("grammar"):
            kw["ts_cfg"], row_prompt = ts_cfg, prompt[:3]
        if opts.get("pads"):
            row_prompt = prev + prompt
            kw["pads"] = torch.tensor([(5, 21, 40)[r % 3] for r in range(b)],
                                      dtype=torch.int32, device="cuda")
        seed = None
        if opts.get("temperature"):
            kw.update(temperature=opts["temperature"], with_scores=True)
            seed = 3
        p_t = torch.tensor(row_prompt, device="cuda")

        def run(eager=False):
            extra = {}
            if seed is not None:
                extra["generator"] = torch.Generator(
                    device="cuda").manual_seed(seed)
            _zero_counts(results)
            with _graph_launches() as graph_launches:
                if eager:
                    with _eager_loop(s_):
                        out = s_._greedy(enc_, p_t, *masks, 128, eot, **kw,
                                         **extra)
                else:
                    out = s_._greedy(enc_, p_t, *masks, 128, eot, **kw,
                                     **extra)
            out = tuple(t.cpu() for t in out) if isinstance(out, tuple) \
                else (out.cpu(),)
            return out, _counts(results), len(graph_launches), \
                _condition_count()

        eager_out, eager_c, _, eager_cond = run(eager=True)
        got = [run(), run()]               # the capture's call, a later one
        # C once a graphed call, ahead of the node: the body ends in the
        # tail, which sets the condition
        if eager_cond != 0 or any(g[3] != 1 for g in got):
            raise AssertionError(f"(b) {label}: C launched {eager_cond} "
                                 f"times eagerly, {[g[3] for g in got]} a "
                                 "graphed call; want 0 and 1")
        body_ops = next(reversed(s_.graphs._loops.values())).body_ops
        if not all(all(torch.equal(a, b_) for a, b_ in zip(g[0], eager_out))
                   for g in got):
            raise AssertionError(f"(b) {label}: graphed tokens (or scores) "
                                 "differ from the eager loop's")
        if any(g[1] != eager_c for g in got) or any(g[2] != 1 for g in got):
            raise AssertionError(f"(b) {label}: launches graphed "
                                 f"{[g[1] for g in got]}, eager {eager_c}; "
                                 f"graph launches a call "
                                 f"{[g[2] for g in got]}, want 1")
        if (eager_c["gumbel_pick"] > 0) != (seed is not None):
            raise AssertionError(f"(b) {label}: the sampled pick launched "
                                 f"{eager_c['gumbel_pick']} times")
        if seed is not None:
            sampled_counts = got[1][1]
        launched = {k: v for k, v in eager_c.items() if v}
        print(f"[graph] (b) {label}, bucket {b}, 128 tokens, on {card}: "
              f"graphed tokens bitwise the eager loop's"
              f"{'' if seed is None else ' (sampled: the key in the state)'}"
              f"; one graph launch a call, C once a call; an iteration "
              f"{body_ops} device operations; launches equal {launched}",
              flush=True)
        note(label, s_)

    # (c) the async dispatch, and the sequential mode's windows
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p_ // golden.HOP for p_ in chunk_starts(len(audio), 480_000,
                                                      400_000)]
    chunks = _bucket_chunks(session, audio)
    dispatch, enc_host = [], []
    pre_tally = {}
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.encoder(chunks)
        enc_host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        ev0.record()
        t0 = time.perf_counter()
        with _graph_launches() as graph_launches:
            pieces = session.transcribe_from_mel_async(
                mel, starts, prompt, 128, eot, gen_cfg.suppress_tokens,
                gen_cfg.begin_suppress_tokens)
        host_s = time.perf_counter() - t0
        ev1.record()
        toks = session.gather_tokens(pieces, len(starts), 128)
        dispatch.append((host_s, ev0.elapsed_time(ev1) / 1e3,
                         time.perf_counter() - t0, sum(graph_launches)))
        if not np.array_equal(toks, x5[2]):
            raise AssertionError("(c) async tokens differ from the main "
                                 "path's")
        if len(graph_launches) != 1:
            raise AssertionError(f"(c) {len(graph_launches)} graph launches "
                                 "an _async call, want 1")
    host_s, dev_s, all_s, launch_ms = (
        statistics.median(d[i] for d in dispatch[1:]) for i in range(4))
    enc_s = statistics.median(enc_host[1:])
    # the program holds the encoder: its kernels are in the launch's tally
    for k, loop in session.graphs._loops.items():
        if k.front[:1] == ("chunks",) and k.rows == 16:
            pre_tally = {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": c
                         for (m, n), c in loop.pre_tally.items()}
    if not (pre_tally.get("attention.launches")
            and pre_tally.get("encoder_mlp.launches")):
        raise AssertionError(f"(c) the bucket program's pre-node tally "
                             f"{pre_tally}: B1 and B2 not in it")
    # a second call at a key with other inputs: the file reversed, so
    # other chunks; its own eager tokens and scores, bitwise, no new key,
    # and scores other than the first call's (random weights decode most
    # chunks into the same tokens: the scores show a frozen input)
    other = np.ascontiguousarray(audio[::-1])
    o_nv = golden.num_frames(len(other))
    o_mel = session.compute_mel(golden.reflect_pad(other), o_nv,
                                mel_frame_bucket(o_nv))

    def scored(m):
        return session.transcribe_from_mel(
            m, starts, prompt, 128, eot, gen_cfg.suppress_tokens,
            gen_cfg.begin_suppress_tokens, with_scores=True)

    first = scored(mel)                      # captures the key with scores
    keys = set(session.graphs.captures())
    got = scored(o_mel)
    with _eager_loop(session):
        want2 = scored(o_mel)
    if not all(np.array_equal(a, b) for a, b in zip(got, want2)) or set(
            session.graphs.captures()) != keys or np.array_equal(
            first[1], got[1]):
        raise AssertionError("(c) a second call at the bucket's key with "
                             "other audio: not its eager result, a new key, "
                             "or the first call's scores")
    pools = {k: v for k, v in session.graphs.pools().items()
             if k.front[:1] == ("chunks",)}
    transcribe_sequential(session, synth_audio(76.0), "en", "transcribe",
                          128, condition_on_prev_text=True)
    seq_keys = [k for k in session.graphs.captures()
                if k.rows == 1 and k.ts_cfg is not None and k.pads]
    if not seq_keys:
        raise AssertionError("(c) the sequential mode's windows ran no graph "
                             "of bucket 1 with the grammar and pad_count")
    note("sequential windows", session)
    gib = 2**-30
    print(f"[graph] (c) whisper-base x5, {len(starts)} chunks, on {card}: "
          f"transcribe_from_mel_async returns after {host_s * 1e3:.3f} ms of "
          f"host time (one graph launch of the bucket's program: the "
          f"encoder, the prefill and the loop; the launch itself "
          f"{launch_ms:.3f} ms; queueing the encoder alone "
          f"{enc_s * 1e3:.3f} ms); the card's span of the work it queued "
          f"{dev_s * 1e3:.3f} ms; to the tokens on the host "
          f"{all_s * 1e3:.3f} ms (median of 3 after one); the program's "
          f"pre-node tally {pre_tally}; a second call at the key with other "
          f"audio (the file reversed) bitwise its eager tokens and scores, "
          f"no new key; "
          f"the chunk programs' pools "
          + ", ".join(f"rows {k.rows}: {v * gib:.4f} GiB"
                      for k, v in pools.items())
          + f"; the sequential mode's windows replay {len(seq_keys)} "
          f"graph(s) of bucket 1 with the grammar and pad_count",
          flush=True)

    # (d) capture seconds and memory
    print(f"[graph] (d) on {card}: seconds to capture a key (the "
          f"program's work once on side streams, the trial captures, then "
          f"the capture), {len(captures)} keys: "
          + "; ".join(f"{label}, rows {k.rows}, prompt {k.prompt_len}: "
                      f"{secs:.4f}" for k, (label, secs) in captures.items()),
          flush=True)
    print(f"[graph] (d) device memory of an x5 session over the file, "
          f"memory_allocated() less before the session (its weights "
          f"{weights_mem * gib:.4f} GiB), on {card}: kept after an eager run "
          f"{eager_mem[0] * gib:.4f} GiB (peak {eager_mem[1] * gib:.4f}), "
          f"kept after the graphed run {graph_mem[0] * gib:.4f} GiB (peak "
          f"{graph_mem[1] * gib:.4f}; what its graphs count, state, inputs "
          f"and pools, {graph_mem[2] * gib:.4f}, of it pools "
          f"{graph_mem[3] * gib:.4f}, reserved "
          f"{graph_mem[4] * gib:.4f} GiB more than after the eager run)",
          flush=True)

    # (d) keys adding up in a fresh session
    from whisper_tpu_torch.pipeline.fallback import DEFAULT_TEMPERATURES
    from whisper_tpu_torch.runtime.generate import _budget

    del sessions, session, s_, enc_
    base_mem = kept(0)
    s_ = make_session("cuda", params, "x5")
    enc16 = _bucket_encoder_states(s_, audio)[0]
    weights_mem = kept(base_mem)          # with the encoder states (16 rows)
    stages = []

    def stage(label):
        stages.append((label, len(s_.graphs.captures()),
                       kept(base_mem) - weights_mem, s_.graphs.nbytes(),
                       sum(s_.graphs.pools().values())))

    for b in (1, 2, 4, 8, 16):
        s_.warmup(b, prompt, 128, eot)
    stage("buckets 1-16 warmed")
    for b in (1, 2, 4, 8, 16):
        for t in DEFAULT_TEMPERATURES:
            s_._greedy(enc16[:b].contiguous(), prompt_t, *masks, 128, eot,
                       temperature=t, with_scores=True,
                       generator=torch.Generator(device="cuda").manual_seed(3)
                       if t > 0 else None)
    stage(f"the ladder's {len(DEFAULT_TEMPERATURES)} temperatures with "
          "scores at each bucket")
    for n_prev in (1, 2, 3, 4):
        s_._greedy(enc16[:1].contiguous(),
                   torch.tensor(prev[:n_prev] + prompt, device="cuda"),
                   *masks, 128, eot)
    stage("prompt lengths 5-8 at bucket 1")
    # the warm-ups' 5 chunk programs (a bucket each); the ladder's calls on
    # given encoder states, 2 a bucket (T = 0 with scores, and one key for
    # every T > 0): 15; at bucket 1 four more prompt lengths: 19
    if [st[1] for st in stages] != [5, 15, 19]:
        raise AssertionError(f"(d) keys as they add up {stages}: want 5 "
                             "chunk programs, 15 (T = 0 and one key for "
                             "every T > 0 a bucket), 19")
    print(f"[graph] (d) a fresh x5 session's keys adding up, on {card}: "
          + "; ".join(f"{label}: {n} keys, memory_allocated() less the "
                      f"session's weights and 16 rows of encoder states "
                      f"{m * gib:.4f} GiB, what its graphs count (state, "
                      f"inputs, pools) {c * gib:.4f} GiB, of it pools "
                      f"{pl * gib:.4f} GiB"
                      for label, n, m, c, pl in stages)
          + f"; budget {_budget(torch.device('cuda', 0)) * gib:.4f} GiB; "
          f"[graph] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sampled_counts, check_while_node(card)


def check_while_node(card: str, trips: int = 128, rows: int = 16) -> dict:
    """(g) What the decode loops' while node costs an iteration, with and
    without its condition kernel (C, ``set_condition_kernel`` in
    ``csrc/graph_cond.cu``) ending the body, and C and the greedy step's
    tail (``ops.loop_tail``) alone: graphs of one while node
    (``runtime.generate._while_node``, on "``trips`` < 128 and some of 16
    rows undone", the rows never done) whose body is one kernel that adds
    one to the counter (``wt_launch_count``) followed by C; the tail
    setting the condition itself; the same tail followed by C; against
    flat graphs of 128 launches of the counting kernel, of the tail, of C
    (``wt_condition_kernels``: then a node that runs no iteration) and of
    an empty kernel (``wt_launch_floor``).  Each replay after its reset,
    CUDA events around the replay alone, the graphs in turns.  A trip of
    the node less a launch of its body in a flat graph is what the node
    costs; the tail followed by C less the tail alone is what C costs in a
    body."""
    import torch

    from whisper_tpu_torch.ops import kernels, loop_tail

    lib = kernels.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(29)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    done = torch.zeros(rows, dtype=torch.bool, device=dev)

    def bump():
        kernels.check(lib.wt_launch_count(count.data_ptr(),
                                          kernels.stream_ptr(dev)),
                      "launch_count")

    def empty():
        kernels.check(lib.wt_launch_floor(kernels.stream_ptr(dev)),
                      "launch_floor")

    def conditions():
        kernels.check(lib.wt_condition_kernels(
            done.data_ptr(), rows, count.data_ptr(), kernels.stream_ptr(dev),
            trips), "condition_kernels")

    # three states whose picks never end a row (ids below EOT_ID)
    tails = [_tail_state(g, rows, 0, False, 2, cols=trips) for _ in range(3)]
    for st in tails:
        st[0].clamp_(max=EOT_ID - 1)
        st[2].zero_()

    def tail_of(st):
        return lambda: loop_tail.loop_tail(*st, eot_id=EOT_ID)

    def reset_of(st):
        return lambda: (st[6].zero_(), st[2].zero_())

    bump()
    empty()
    graphs = {"flat count": _flat_graph(bump, trips),
              "flat empty": _flat_graph(empty, trips),
              "flat tail": _flat_graph(tail_of(tails[0]), trips),
              # its launches and the node that owns their handle are made
              # inside the capture
              "flat C": _flat_graph(conditions, 1, warm=False)}
    graphs["count + C"] = _node_graph(done, count, trips, bump)[0]
    sets, ops_sets = _node_graph(tails[1][2], tails[1][6], trips,
                                 tail_of(tails[1]), tail=True)
    graphs["tail sets it"] = sets
    then_c, ops_c = _node_graph(tails[2][2], tails[2][6], trips,
                                tail_of(tails[2]))
    graphs["tail + C"] = then_c
    resets = {"flat count": count.zero_, "count + C": count.zero_,
              "flat tail": reset_of(tails[0]),
              "tail sets it": reset_of(tails[1]),
              "tail + C": reset_of(tails[2])}
    for name in ("count + C", "tail sets it", "tail + C"):
        resets[name]()
        graphs[name].replay()
        torch.cuda.synchronize()
        ran = int(count) if name == "count + C" else int(
            tails[1 if name == "tail sets it" else 2][6])
        if ran != trips:
            raise AssertionError(f"(g) the while node ({name}) ran {ran} "
                                 f"trips, expected {trips}")
    if (ops_sets["body_ops"], ops_c["body_ops"]) != (1, 2):
        raise AssertionError(f"(g) body operations: the tail setting the "
                             f"condition {ops_sets['body_ops']}, the tail "
                             f"and C {ops_c['body_ops']}; want 1 and 2")
    us = _replay_us(graphs, resets, trips)
    node_us = us["count + C"] - us["flat count"]
    bare_us = us["tail sets it"] - us["flat tail"]
    c_us = us["tail + C"] - us["tail sets it"]
    print(f"[graph] (g) the while node, on {card}, µs a trip ({trips} "
          f"trips a launch, {rows} rows): a body of one counting kernel "
          f"then C {us['count + C']:.3f} against {us['flat count']:.3f} a "
          f"launch of that kernel in a flat graph: the node and C "
          f"{node_us:.3f}; a body of the greedy tail setting the condition "
          f"itself {us['tail sets it']:.3f} (1 operation) against the tail "
          f"followed by C {us['tail + C']:.3f} (2): the node without C "
          f"{bare_us:.3f}, C in a body {c_us:.3f}; alone in flat graphs of "
          f"{trips}: the tail {us['flat tail']:.3f}, C {us['flat C']:.3f}, "
          f"an empty kernel {us['flat empty']:.3f}", flush=True)
    return {"while_us": us["count + C"], "flat_us": us["flat count"],
            "node_us": node_us, "node_without_c_us": bare_us,
            "c_in_body_us": c_us, "tail_us": us["flat tail"],
            "c_us": us["flat C"], "empty_us": us["flat empty"]}


def _alternated(results, fns: dict, rounds: int):
    """Each mode of ``fns`` ({mode: fn}) but "eager" once to warm up (a
    graphed mode captures there, after an eager warm-up of its step), then
    ``rounds`` rounds in turns, each run through ``_decode_run``: {mode:
    [(result, host seconds, counts), ...]}."""
    for mode, fn in fns.items():
        if mode != "eager":
            fn()
    out = {mode: [] for mode in fns}
    for _ in range(rounds):
        for mode, fn in fns.items():
            out[mode].append(_decode_run(results, fn))
    return out


def _bucket_chunks(session, audio):
    """The mel chunks [16, n_mels, 3000] of the file's bucket (see
    ``_bucket_encoder_states``)."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )

    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    starts += [mel.shape[1]] * (session._batch_bucket(len(starts))
                                - len(starts))
    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    return torch.stack([mel_pad[:, s:s + CHUNK_FRAMES] for s in starts])


def _kept_line(session, kind: str) -> str:
    """Capture seconds and kept state of ``session``'s keys of ``kind``."""
    kept, caps = session.graphs.kept(), session.graphs.captures()
    pools = session.graphs.pools()
    return "; ".join(
        f"rows {k.rows}, prompt {k.prompt_len}, {k.max_new_tokens} "
        f"tokens, {k.front[0]}: capture {caps[k]:.4f} s, kept (state, "
        f"inputs, pools) {kept[k] * 2**-30:.4f} GiB, of it pools "
        f"{pools[k] * 2**-30:.4f}"
        for k in caps if k.kind == kind)


def check_graph_beam_spec(card: str, results, params, dims, audio) -> None:
    """Beam search and speculative rounds run from CUDA graphs against
    the same loops run eagerly (``[graph]`` (e), (f) lines), whisper-base,
    the 301.574 s file, 128 tokens, the eager loops reading ``done`` every
    step (round), where the graphed ones stop.  (e) beams K = 4 (64 beam
    rows) at x5 and x4 through the long-form path, graphed and eager
    alternated, two runs each after the graphed run's warm-up (its
    capture): tokens bitwise and launches equal, e2e and model_s (median);
    at x5 the bucket's beam decode (no read, 127 steps) graphed and eager,
    ms a step with the prefill taken out, and the grammar and left-padded
    prompts graphed against eager (tokens, scores and launches); (f) speculative at x5 and x4 with a random whisper-tiny
    draft and with the model's own int8 weights as draft (shared encoder),
    draft_k 4, one graphed run after its capture and one eager: tokens
    bitwise, rounds and launches equal, rounds counted and rounds run (B7
    launches / layers), e2e and model_s; at x5 the bucket's decode, ms a
    round graphed.  Each key's capture seconds and kept state."""
    import numpy as np
    import torch

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params

    t_phase = time.perf_counter()
    n_l = dims.decoder_layers
    special = special_tokens("en", "transcribe", None)
    eot = special.eot
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    prompt_t = torch.tensor(prompt, device="cuda")
    gen_cfg = GenerationCfg()

    def run(session, eager, **kw):
        """The long-form path over the file: (tokens, Timing); eagerly,
        ``done`` read every step (round), where the graphed loops stop."""
        collector = []
        with (_eager_loop(session) if eager
              else contextlib.nullcontext()):
            _, timing = transcribe_longform(
                session, audio, "en", "transcribe", 128,
                token_collector=collector, **kw)
        return collector[0], timing

    def same(runs, label, extra=lambda out: ()):
        """Every run's tokens (and ``extra``) and launches the first
        eager run's."""
        (want, _, want_c) = runs["eager"][0]
        for mode, rs in runs.items():
            for out, _, c in rs:
                if not (np.array_equal(out[0], want[0])
                        and extra(out) == extra(want)):
                    raise AssertionError(f"{label}, {mode}: tokens differ "
                                         "from the eager loop's")
                if c != want_c:
                    raise AssertionError(f"{label}, {mode}: launches {c}, "
                                         f"eager {want_c}")
        return want_c

    def medians(runs):
        return {m: (statistics.median(r[1] for r in rs),
                    statistics.median(r[0][1].model_only_s for r in rs))
                for m, rs in runs.items()}

    # (e) beams K = 4
    for variant, on in (("x5", "cross_attend_step"),
                        ("x4", "cross_attend_step_dequant")):
        session = make_session("cuda", params, variant)
        runs = _alternated(results, {
            "graphed": lambda s=session: run(s, False, num_beams=4),
            "eager": lambda s=session: run(s, True, num_beams=4)}, 2)
        c = same(runs, f"(e) beams {variant}")
        steps = c[on] // n_l
        if not (c[on] == steps * n_l and 0 < steps <= 127
                and c["self_attend_step"] == 0):
            raise AssertionError(f"(e) beams {variant}: launches {c}")
        med = medians(runs)
        line = (f"[graph] (e) beams K = 4, whisper-base {variant}, 64 beam "
                f"rows, on {card}: e2e graphed {med['graphed'][0]:.4f} s "
                f"(model {med['graphed'][1]:.4f}), eager "
                f"{med['eager'][0]:.4f} s (model {med['eager'][1]:.4f}), "
                f"alternated, median of 2; tokens bitwise, launches equal, "
                f"{steps} steps run")
        if variant == "x5":
            enc = session.encoder(_bucket_chunks(session, audio))
            masks = session._get_masks(gen_cfg.suppress_tokens,
                                       gen_cfg.begin_suppress_tokens)

            def beams(n_new, eager, early_exit=False, **kw):
                return beam_generate(
                    session._decoder_params, dims, enc, kw.pop(
                        "prompt", prompt_t), *masks, n_new, eot, 4,
                    int8_cross_kv=True, packed_cross=True, int8_mxu=True,
                    early_exit=early_exit, eager=eager,
                    graphs=session.graphs, **kw)

            def decode_s(n_new, eager):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beams(n_new, eager)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            step_ms = {}
            for mode, eager in (("graphed", False), ("eager", True)):
                for n_new in (1, 128):
                    decode_s(n_new, eager)
                pre = statistics.median(decode_s(1, eager) for _ in range(3))
                whole = statistics.median(decode_s(128, eager)
                                          for _ in range(3))
                step_ms[mode] = (whole - pre) * 1e3 / 127
            line += (f"; the bucket's beam decode (127 steps, no read) "
                     f"{step_ms['graphed']:.4f} ms a step graphed, "
                     f"{step_ms['eager']:.4f} eager (host clock, prefill "
                     f"taken out)")
            prev = [special.sot_prev] + np.random.default_rng(17).integers(
                220, 50000, 63).tolist()
            for label, kw in (
                    ("the grammar", dict(
                        prompt=prompt_t[:3], ts_cfg=TimestampCfg(
                            special.no_timestamps + 1, eot,
                            special.no_timestamps))),
                    ("a 68-slot prompt left-padded", dict(
                        prompt=torch.tensor(prev + prompt, device="cuda"),
                        pad_count=torch.tensor(
                            [(5, 21, 40)[r % 3] for r in range(16)],
                            dtype=torch.int32, device="cuda")))):
                got = {}
                for mode, eager in (("eager", True), ("graphed", False),
                                    ("replayed", False)):
                    (toks, sc), _, c_ = _decode_run(
                        results, lambda: beams(128, eager, True, **dict(kw)))
                    got[mode] = (toks.cpu(), sc.cpu(), c_)
                if any(not (torch.equal(g[0], got["eager"][0])
                            and torch.equal(g[1], got["eager"][1])
                            and g[2] == got["eager"][2])
                       for g in got.values()):
                    raise AssertionError(f"(e) beams with {label}: graphed "
                                         "differs from eager")
                line += (f"; with {label}: tokens and scores bitwise, "
                         f"launches equal")
        print(line + f"; keys: {_kept_line(session, 'beam')}", flush=True)
        del session

    # (f) speculative rounds
    tiny = get_dims("openai/whisper-tiny")
    drafts = (("a random whisper-tiny draft", init_params(tiny, seed=1),
               tiny, False),
              ("its own int8 weights as draft", quantize_params(params),
               dims, True))
    for variant in ("x5", "x4"):
        session = make_session("cuda", params, variant)
        for label, draft, d_dims, share in drafts:
            session.set_draft_model(draft, d_dims, share_encoder=share)

            def spec(eager, s=session):
                out = run(s, eager, speculative=True, draft_k=4)
                return out + (int(sum(r for r, _ in s.speculative_stats)),)

            runs = _alternated(results, {"graphed": lambda: spec(False),
                                         "eager": lambda: spec(True)}, 1)
            c = same(runs, f"(f) speculative {variant}, {label}",
                     extra=lambda out: out[2])
            rounds = runs["eager"][0][0][2]
            run_rounds = c["cross_attend_multi"] // n_l   # either B7
            if run_rounds != rounds:
                raise AssertionError(f"(f) {variant}, {label}: {rounds} "
                                     f"rounds, {run_rounds} run")
            med = medians(runs)
            line = (f"[graph] (f) speculative, whisper-base {variant}, "
                    f"{label}, draft_k 4, on {card}: e2e graphed "
                    f"{med['graphed'][0]:.4f} s (model "
                    f"{med['graphed'][1]:.4f}), eager {med['eager'][0]:.4f} "
                    f"s (model {med['eager'][1]:.4f}), one run each after the "
                    f"capture; tokens bitwise, rounds and launches equal; "
                    f"{rounds} rounds counted, {run_rounds} run")
            if variant == "x5":
                chunks = _bucket_chunks(session, audio)
                enc = session.encoder(chunks)
                masks = session._get_masks(gen_cfg.suppress_tokens,
                                           gen_cfg.begin_suppress_tokens)

                def decode(n_new):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, (r, _) = session._speculative_tokens(
                        chunks, enc, prompt_t, *masks, n_new, eot, 4)
                    torch.cuda.synchronize()
                    return time.perf_counter() - t0, int(r)

                for n_new in (1, 128):                # captures
                    decode(n_new)
                _zero_counts(results)
                whole, r = decode(128)
                ran = _counts(results)["cross_attend_multi"] // n_l
                round_ms = (whole - decode(1)[0]) * 1e3 / (ran - 1)
                line += (f"; the bucket's decode, ms a round run graphed "
                         f"{round_ms:.4f} ({r} rounds counted, {ran} run; "
                         f"host clock, prefills and a round taken out)")
            print(line + f"; keys: {_kept_line(session, 'speculative')}",
                  flush=True)
        del session
    print(f"[graph] (e), (f) phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _ending_id(toks, steps: int = 12):
    """(id, rows, ends): the id that, declared end-of-text, ends the most
    rows of ``toks`` (a decode with an end-of-text id no row emits) at a
    step in 1 .. ``steps``, at two steps or more (a row that holds it in
    column 0 would end at once: not counted); ties to more distinct
    steps.  Random weights decode a row into runs of a few ids, so such an
    id ends the rows that share it, each at its own step."""
    best = None
    for c in {int(t) for t in toks[:, 1:steps + 1].flatten()}:
        rows, ends = [], []
        for r, row in enumerate(toks):
            hit = [i for i in range(1, steps + 1) if row[i] == c]
            if hit and row[0] != c:
                rows.append(r)
                ends.append(hit[0])
        score = (len(rows), len(set(ends)))
        if len(set(ends)) > 1 and (best is None or score > best[0]):
            best = (score, c, rows, ends)
    if best is None:
        raise AssertionError("[exit]: no id ends two rows at two steps "
                             f"within {steps}")
    return best[1:]


def check_exit(card: str, results, params, dims, audio) -> None:
    """The decode loops' exit on the card (``[exit]`` lines): each graphed
    greedy, beam and speculative decode is one launch of a graph whose
    step (round) is the body of a while node on "trips < n and some row
    undone", so the card stops where ``lax.while_loop`` stops.  whisper-base x5, the 301.574 s file's chunks, 128 tokens; an
    end-of-text id that the file's chunks emit at steps of their own within
    12 (``_ending_id``, from the eager decode with the real end-of-text,
    which random weights never emit), and a bucket of 16 made of the
    chunks that hold it (in turn) and a bucket of 1.  Against the eager
    loop reading ``done`` every step (round), which stops where the JAX
    loop does: (a) greedy at bucket 16 and 1, synchronous and ``_async``:
    tokens, sum_lp and n_tok bitwise, launches equal, steps run (B3
    launches / layers) the last row's end; (b) beams K = 4 at bucket 16,
    the session's forms and ``beam_generate`` (tokens and scores); (c)
    speculative with a random whisper-tiny draft and with the model's own
    int8 weights: tokens and rounds bitwise, launches equal, rounds run
    (B7 launches / layers) the rounds counted.  Beside each, device ms of
    the decode (CUDA events) against the same call whose rows never end
    (greedy and beams: exactly n - first = 127 steps), and the host ms
    until each ``_async`` form returns, one graph launch, beside the host
    ms to queue the encoder alone and against the card's span of the work
    it queued (``transcribe_short_speculative_async``: the serving tick's
    leg, 16 windows of 30 s; with either draft within half the span).  Any
    mismatch raises."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params

    t_phase = time.perf_counter()
    n_l = dims.decoder_layers
    special = special_tokens("en", "transcribe", None)
    never = special.eot                 # random weights never emit it
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    prompt_t = torch.tensor(prompt, device="cuda")
    gen_cfg = GenerationCfg()
    sup = (gen_cfg.suppress_tokens, gen_cfg.begin_suppress_tokens)
    session = make_session("cuda", params, "x5")
    masks = session._get_masks(*sup)
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p_ // golden.HOP for p_ in chunk_starts(len(audio), 480_000,
                                                      400_000)]
    with _eager_loop(session):
        base = session.transcribe_from_mel(mel, starts, prompt, 128, never,
                                           *sup)
    eot, rows, ends = _ending_id(base)
    buckets = {16: [starts[rows[i % len(rows)]] for i in range(16)],
               1: [starts[rows[0]]]}
    print(f"[exit] whisper-base x5, on {card}: end-of-text {eot} ends "
          f"chunks {rows} of {len(starts)} at steps {ends}; bucket 16 of "
          "them in turn, bucket 1 the first", flush=True)

    def chunks_of(b_starts):
        mel_pad = torch.nn.functional.pad(mel, (0, 3000))
        return torch.stack([mel_pad[:, s_:s_ + 3000] for s_ in b_starts])

    def device_ms(fn, calls: int = 3):
        """Median device ms of ``fn()`` (CUDA events around it), warmed."""
        fn()
        out = []
        for _ in range(calls):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
            ev0.record()
            fn()
            ev1.record()
            ev1.synchronize()
            out.append(ev0.elapsed_time(ev1))
        return statistics.median(out)

    def async_ms(fn, calls: int = 3):
        """Median (host ms until ``fn()`` returns, device ms of the span
        of the work it queued, host ms of its graph launch), warmed; each
        call one graph launch."""
        fn()
        out = []
        for _ in range(calls):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
            ev0.record()
            t0 = time.perf_counter()
            with _graph_launches() as graph_launches:
                res = fn()
            host = (time.perf_counter() - t0) * 1e3
            ev1.record()
            ev1.synchronize()
            out.append((host, ev0.elapsed_time(ev1), sum(graph_launches)))
            del res
            if len(graph_launches) != 1:
                raise AssertionError(f"[exit] {len(graph_launches)} graph "
                                     "launches an _async call, want 1")
        return tuple(statistics.median(o[i] for o in out) for i in (0, 1, 2))

    def queue_ms(fn, calls: int = 3):
        """Median host ms until ``fn()`` returns, the card idle before."""
        out = []
        for _ in range(calls + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out[1:])

    def same(label, runs):
        """Every run's result and counts those of the first (the eager
        per-step loop's)."""
        (want, _, want_c) = runs[0][1]
        for mode, (out, _, c) in runs[1:]:
            if not all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(out, want)):
                raise AssertionError(f"[exit] {label}: {mode} results differ "
                                     "from the eager per-step loop's")
            if c != want_c:
                raise AssertionError(f"[exit] {label}: {mode} launches {c}, "
                                     f"eager {want_c}")
        return want, want_c

    # (a) greedy, bucket 16 and 1
    for b, b_starts in buckets.items():
        chunks_b = chunks_of(b_starts)
        enc_ms = queue_ms(lambda: session.encoder(chunks_b))
        def sync(e=eot, st=b_starts):
            return session.transcribe_from_mel(mel, st, prompt, 128, e, *sup,
                                               with_scores=True)

        def asynced(st=b_starts):
            pieces = session.transcribe_from_mel_async(
                mel, st, prompt, 128, eot, *sup, with_scores=True)
            return session.gather_tokens(pieces, len(st), 128, True)

        with _eager_loop(session):
            eager = _decode_run(results, sync)
        runs = [("eager", eager)] + [
            (mode, _decode_run(results, fn)) for mode, fn in (
                ("synchronous", sync), ("synchronous", sync),
                ("_async", asynced))]
        (toks, _, n_tok), c = same(f"(a) greedy, bucket {b}", runs)
        steps = c["self_attend_step"] // n_l
        trip = int(n_tok.max()) - 1          # the JAX loop's trip count
        row_ends = sorted({int(n) - 1 for n in n_tok})
        if not (steps == trip < 127 and c["cross_attend_step"] == steps
                * n_l):
            raise AssertionError(f"[exit] (a) bucket {b}: {steps} steps run, "
                                 f"the while loop's {trip}; launches {c}")
        enc = session.encoder(chunks_b)
        ms = {name: device_ms(lambda e=e: session._greedy(
            enc, prompt_t, *masks, 128, e, early_exit=False))
            for name, e in (("ending", eot), ("never ending", never))}
        _, _, c_never = _decode_run(results, lambda: session._greedy(
            enc, prompt_t, *masks, 128, never))
        if c_never["self_attend_step"] != 127 * n_l:
            raise AssertionError(f"[exit] (a) bucket {b}, no row ending: "
                                 f"{c_never['self_attend_step'] / n_l} "
                                 "steps run, want n - first = 127")
        host, span, _ = async_ms(
            lambda st=b_starts: session.transcribe_from_mel_async(
                mel, st, prompt, 128, eot, *sup))
        print(f"[exit] (a) greedy x5, bucket {b}, on {card}: tokens, sum_lp "
              f"and n_tok bitwise the eager per-step loop's (synchronous, "
              f"twice, and _async); rows end at steps {row_ends}; {steps} "
              f"steps run = the while loop's trip count {trip}; launches "
              f"equal {c['self_attend_step']} B3, {c['cross_attend_step']} "
              f"B4; the decode's device ms {ms['ending']:.4f}, "
              f"{ms['never ending']:.4f} with no row ending (median of 3; "
              f"127 = n - first steps run); transcribe_from_mel_async "
              f"returns after {host:.3f} ms of host time, one graph launch "
              f"(queueing the encoder alone {enc_ms:.3f} ms), the card's "
              f"span of its work {span:.3f} ms", flush=True)

    # (b) beams K = 4, bucket 16, the ids of those rows' first steps kept
    # (every other id suppressed), so that every beam ends
    b_starts = buckets[16]
    chunks16 = chunks_of(b_starts)
    enc = session.encoder(chunks16)
    enc_ms = queue_ms(lambda: session.encoder(chunks16))
    keep = {int(t) for t in base[rows, :13].flatten()} | {eot}
    b_sup = ([i for i in range(dims.vocab_size) if i not in keep], sup[1])
    b_masks = session._get_masks(*b_sup)

    def beams(e=eot, eager=False):
        return beam_generate(session._decoder_params, dims, enc, prompt_t,
                             *b_masks, 128, e, 4, int8_cross_kv=True,
                             packed_cross=True, int8_mxu=True, eager=eager,
                             graphs=session.graphs)

    def beam_sync():
        return (session.transcribe_from_mel(mel, b_starts, prompt, 128, eot,
                                            *b_sup, num_beams=4),)

    def beam_async():
        return (session.gather_tokens(session.transcribe_from_mel_async(
            mel, b_starts, prompt, 128, eot, *b_sup, num_beams=4),
            len(b_starts), 128),)

    with _eager_loop(session):
        eager = _decode_run(results, beam_sync)
    runs = [("eager", eager), ("synchronous", _decode_run(results, beam_sync)),
            ("synchronous", _decode_run(results, beam_sync)),
            ("_async", _decode_run(results, beam_async))]
    _, c = same("(b) beams, the session's forms", runs)
    steps = c["cross_attend_step"] // n_l
    runs = [("eager", _decode_run(results, lambda: tuple(
        t.cpu() for t in beams(eager=True))))] + [
        ("beam_generate", _decode_run(results, lambda: tuple(
            t.cpu() for t in beams()))) for _ in range(2)]
    _, c2 = same("(b) beam_generate", runs)
    if not (0 < steps and 0 < c2["cross_attend_step"]
            and c["self_attend_step"] == 0):
        raise AssertionError(f"[exit] (b) beams: {steps} steps run; launches "
                             f"{c}, {c2}")
    ms = {name: device_ms(lambda e=e: beams(e)) for name, e in (
        ("ending", eot), ("never ending", never))}
    _, _, c_never = _decode_run(results, lambda: beams(never))
    if c_never["cross_attend_step"] != 127 * n_l:
        raise AssertionError(f"[exit] (b) beams, no beam ending: "
                             f"{c_never['cross_attend_step'] / n_l} steps "
                             "run, want n - first = 127")
    host, span, _ = async_ms(lambda: session.transcribe_from_mel_async(
        mel, b_starts, prompt, 128, eot, *b_sup, num_beams=4))
    print(f"[exit] (b) beams K = 4 x5, bucket 16 (64 beam rows), ids kept "
          f"{sorted(keep)}, on {card}: "
          f"tokens (and beam_generate's scores) bitwise the eager per-step "
          f"loop's (synchronous, twice, and _async); {steps} steps run "
          f"({c2['cross_attend_step'] // n_l} by beam_generate) "
          f"{'(every beam ended)' if steps < 127 else '(a beam ran to the bound)'}"
          f", launches equal {c['cross_attend_step']} B4; the decode's "
          f"device ms {ms['ending']:.4f}, {ms['never ending']:.4f} with no "
          f"beam ending (127 = n - first steps run); the _async form returns "
          f"after {host:.3f} ms of host time, one graph launch (queueing the "
          f"encoder alone {enc_ms:.3f} ms), the card's span {span:.3f} ms",
          flush=True)

    # (c) speculative
    tiny = get_dims("openai/whisper-tiny")
    hop = (len(audio) - 480_000) // 15
    padded = np.stack([golden.reflect_pad(audio[i * hop:i * hop + 480_000])
                       for i in range(16)])
    n_valid = np.full(16, 3000, np.int32)
    chunks = chunks_of(b_starts)
    for label, draft, d_dims, share in (
            ("a random whisper-tiny draft", init_params(tiny, seed=1), tiny,
             False),
            ("its own int8 weights as draft", quantize_params(params), dims,
             True)):
        session.set_draft_model(draft, d_dims, share_encoder=share)

        def spec(e=eot):
            toks = session.transcribe_from_mel(mel, b_starts, prompt, 128, e,
                                               *sup, speculative=True)
            return toks, int(sum(r for r, _ in session.speculative_stats))

        def spec_async():
            pieces = session.transcribe_from_mel_async(
                mel, b_starts, prompt, 128, eot, *sup, speculative=True)
            toks = session.gather_tokens(pieces, len(b_starts), 128)
            return toks, int(sum(r for r, _ in session.speculative_stats))

        with _eager_loop(session):
            eager = _decode_run(results, spec)
        runs = [("eager", eager), ("synchronous", _decode_run(results, spec)),
                ("synchronous", _decode_run(results, spec)),
                ("_async", _decode_run(results, spec_async))]
        (_, rounds), c = same(f"(c) speculative, {label}", runs)
        ran = c["cross_attend_multi"] // n_l
        if not 0 < ran == rounds < 128:
            raise AssertionError(f"[exit] (c) {label}: {rounds} rounds, "
                                 f"{ran} run")
        never_rounds = spec(never)[1]
        ms = {name: device_ms(lambda e=e: session._speculative_tokens(
            chunks, enc, prompt_t, *masks, 128, e, 4))
            for name, e in (("ending", eot), ("never ending", never))}
        loop_host, loop_span, _ = async_ms(
            lambda: session._speculative_tokens(
                chunks, enc, prompt_t, *masks, 128, never, 4))
        host, span, launch = async_ms(
            lambda: session.transcribe_short_speculative_async(
                padded, n_valid, prompt, 128, never, *sup))
        t0 = time.perf_counter()
        session._short_rows(padded, n_valid)       # the rows' wire encoding
        encode_ms = (time.perf_counter() - t0) * 1e3
        if not (loop_host < 0.5 * loop_span and host < 0.5 * span):
            raise AssertionError(
                f"[exit] (c) {label}: the _async dispatch returned after "
                f"{host:.3f} ms of a {span:.3f} ms span (the rounds alone "
                f"{loop_host:.3f} of {loop_span:.3f})")
        # a second call at the short program's key with other audio (the
        # windows reversed): its own eager tokens, bitwise, no new key
        keys = set(session.graphs.captures())
        rev = np.ascontiguousarray(padded[::-1, ::-1])
        got = session.transcribe_short_speculative(rev, n_valid, prompt,
                                                   128, never, *sup)
        with _eager_loop(session):
            want2 = session.transcribe_short_speculative(
                rev, n_valid, prompt, 128, never, *sup)
        if not np.array_equal(got, want2) or set(
                session.graphs.captures()) != keys:
            raise AssertionError(f"[exit] (c) {label}: a second short call "
                                 "at the key with other audio: not its "
                                 "eager result, or a new key")
        print(f"[exit] (c) speculative x5, {label}, draft_k 4, bucket 16, on "
              f"{card}: tokens and rounds bitwise the eager per-round loop's "
              f"(synchronous, twice, and _async); {rounds} rounds counted = "
              f"{ran} run, launches equal {c['cross_attend_multi']} B7 "
              f"({never_rounds} rounds with no row ending); the decode's "
              f"device ms {ms['ending']:.4f}, {ms['never ending']:.4f} with "
              f"no row ending; transcribe_short_speculative_async (16 x 30 "
              f"s, no row ending) returns after {host:.3f} ms of host time "
              f"({100 * host / span:.1f}% of the span), one graph launch of "
              f"the short program (the mel, both encoders, both prefills and "
              f"the rounds; the launch itself {launch:.3f} ms; the rows' "
              f"wire encoding on the host alone {encode_ms:.3f} ms), the "
              f"card's "
              f"span of its work {span:.3f} ms (from given encoder states: "
              f"{loop_host:.3f} ms host, {loop_span:.3f} ms span); within "
              f"half the span; a second short call with other audio bitwise "
              f"its eager tokens, no new key", flush=True)
    del session
    print(f"[exit] phase {time.perf_counter() - t_phase:.1f} s, on {card}",
          flush=True)


def _grammar_errors(row, cfg) -> list:
    """What one generated row breaks of the timestamp grammar
    (``runtime.timestamps``): the first token a timestamp at most
    ``max_initial_timestamp_index`` steps in, no <|notimestamps|>, pairs
    closed (after text and a timestamp no text; after two timestamps no
    third), timestamps never decreasing.  The row is read up to its first
    EOT."""
    gen = []
    for t in row:
        if t == cfg.eot_id:
            break
        gen.append(int(t))
    tsb = cfg.timestamp_begin
    if not gen:
        return ["no first token"]
    errs = []
    if not tsb <= gen[0] <= tsb + cfg.max_initial_timestamp_index:
        errs.append(f"first token {gen[0]}")
    if cfg.no_timestamps_id in gen:
        errs.append("<|notimestamps|>")
    stamps = [t for t in gen if t >= tsb]
    if stamps != sorted(stamps):
        errs.append("timestamps decrease")
    for j in range(1, len(gen)):
        last, pen = gen[j - 1] >= tsb, j < 2 or gen[j - 2] >= tsb
        if last and pen and gen[j] >= tsb:
            errs.append(f"a third timestamp at {j}")
        if last and not pen and gen[j] < cfg.eot_id:
            errs.append(f"an open pair at {j}")
    return errs


def _decode_run(results, fn):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after: (its result, host seconds, counts)."""
    import torch

    _zero_counts(results)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts(results)


def check_decoding(card: str, results, params, dims, audio, x5) -> None:
    """The decoding options on the 301.574 s file (12 chunks, one bucket of
    16, 128 tokens) at whisper-base: (a) the timestamp grammar at x5 and x7
    (B8), every row checked, two runs equal; (b) scores at T = 0, tokens
    bitwise the greedy main path's; (c) the fallback ladder 0-1.0 with every
    gate failing, so every chunk walks every rung (64 tokens a chunk), run
    twice with one seed and once with another; (d) beam search, K = 4 at x5 (B4 at 64 rows) and
    x4 (B6), and K = 1 against greedy decoding on the step beam search
    takes; ``x5``: (e2e, Timing, tokens, counts) of the main path's run.
    Each result on a ``[decoding]`` line."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import whisper
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.pipeline.fallback import (
        DEFAULT_TEMPERATURES,
        transcribe_longform_fallback,
    )
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    t_phase = time.perf_counter()
    n_l = dims.decoder_layers
    special = special_tokens("en", "transcribe", None)
    ts_cfg = TimestampCfg(special.no_timestamps + 1, special.eot,
                          special.no_timestamps)
    greedy = x5[2]

    def longform(session, **kw):
        tokens = []
        _, timing = transcribe_longform(session, audio, "en", "transcribe",
                                        128, token_collector=tokens, **kw)
        return tokens[0], timing

    # (a) the timestamp grammar at x5 (B3, B4) and x7 (B8, B4)
    sessions = {v: make_session("cuda", params, v) for v in ("x5", "x7")}
    for variant, session in sessions.items():
        again, _ = longform(session, timestamps=True)        # and warm-up
        (toks, timing), e2e, c = _decode_run(
            results, lambda: longform(session, timestamps=True))
        errs = {r: _grammar_errors(row, ts_cfg) for r, row in enumerate(toks)}
        errs = {r: e for r, e in errs.items() if e}
        self_step = "self_attend_step_int8" if variant == "x7" \
            else "self_attend_step"
        if toks.shape != greedy.shape or errs or not (again == toks).all():
            raise AssertionError(f"timestamps at {variant}: rows breaking "
                                 f"the grammar {errs}, two runs equal "
                                 f"{bool((again == toks).all())}")
        if not (c[self_step] > 0 and c[self_step] == c["cross_attend_step"]
                and c["fused_attention"] > 0):
            raise AssertionError(f"timestamps at {variant}: launches {c}")
        stamps = float((toks >= ts_cfg.timestamp_begin).sum(1).mean())
        print(f"[decoding] (a) timestamps, whisper-base {variant}, on {card}: "
              f"e2e {e2e:.4f} s, model {timing.model_only_s:.4f} s (greedy "
              f"x5 {x5[0]:.4f} / {x5[1].model_only_s:.4f} s); every row of "
              f"{len(toks)} keeps the grammar, {stamps:.2f} timestamps a row, "
              f"two runs equal; {c[self_step] // n_l} steps; launches {c}",
              flush=True)

    # (b) scores at T = 0: the greedy main path's tokens, bitwise
    session = sessions["x5"]
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    (toks, sum_lp, n_tok), secs, c = _decode_run(
        results, lambda: session.transcribe_from_mel(
            mel, starts, [special.sot, special.lang, special.task,
                          special.no_timestamps], 128, special.eot,
            with_scores=True))
    ends = [int(np.argmax(row == special.eot)) + 1
            if (row == special.eot).any() else len(row) for row in toks]
    if not ((toks == greedy).all() and np.isfinite(sum_lp).all()
            and list(n_tok) == ends):
        raise AssertionError(f"scores at T = 0: tokens equal the greedy "
                             f"run's {bool((toks == greedy).all())}, sum_lp "
                             f"{sum_lp}, n_tok {n_tok.tolist()} against "
                             f"{ends}")
    print(f"[decoding] (b) scores at T = 0, whisper-base x5, on {card}: "
          f"{secs:.4f} s; tokens bitwise the greedy main path's; avg "
          f"log-probability a token {float(sum_lp.sum() / n_tok.sum()):.4f}; "
          f"n_tok {n_tok.tolist()}", flush=True)

    # (c) the fallback ladder, every gate failing: every chunk every rung,
    # 64 tokens a chunk (three ladders of six rungs: the phase's time)
    supp = list(range(1, special.eot, 97)) + list(range(special.sot + 100,
                                                         special.sot + 106))
    gen_cfg = GenerationCfg(suppress_tokens=supp,
                            begin_suppress_tokens=[220, special.eot])
    ladders = []
    for seed in (0, 0, 1):
        rungs = []
        (_, timing, info), secs, c = _decode_run(
            results, lambda: transcribe_longform_fallback(
                session, audio, "en", "transcribe", 64, gen_cfg=gen_cfg,
                logprob_threshold=float("inf"), seed=seed,
                token_collector=rungs))
        if info["accepted_at"] != [1.0] * len(starts) or [
                (t, i) for t, i, _ in rungs] != [
                (t, list(range(len(starts)))) for t in DEFAULT_TEMPERATURES]:
            raise AssertionError(f"ladder, seed {seed}: accepted at "
                                 f"{info['accepted_at']}, rungs "
                                 f"{[(t, i) for t, i, _ in rungs]}")
        drawn = np.concatenate([r[2].reshape(-1) for r in rungs])
        if np.isin(drawn, supp).any():
            raise AssertionError(f"ladder, seed {seed}: a suppressed id drawn")
        if c["gumbel_pick"] == 0:
            raise AssertionError(f"ladder, seed {seed}: the sampled rungs "
                                 "launched no pick kernel")
        ladders.append([r[2] for r in rungs])
        print(f"[decoding] (c) fallback ladder {DEFAULT_TEMPERATURES}, seed "
              f"{seed}, whisper-base x5, on {card}: e2e {secs:.4f} s, model "
              f"{timing.model_only_s:.4f} s for {len(rungs)} rungs of "
              f"{len(starts)} chunks; every chunk accepted at 1.0; no "
              f"suppressed id among {drawn.size} tokens; B4 launches "
              f"{c['cross_attend_step']}, the pick kernel's "
              f"{c['gumbel_pick']}", flush=True)
    same = all((a == b).all() for a, b in zip(*ladders[:2]))
    other = [float((a == b).mean()) for a, b in zip(ladders[0], ladders[2])]
    if not same or min(other[1:]) == 1.0:
        raise AssertionError(f"ladder: one seed twice equal {same}; another "
                             f"seed's share of equal tokens by rung {other}")
    print(f"[decoding] (c) two runs with seed 0 equal at every rung; seed 1 "
          f"against seed 0, share of equal tokens by rung: "
          + ", ".join(f"{t} {x:.4f}" for t, x in zip(DEFAULT_TEMPERATURES,
                                                     other)), flush=True)

    # (d) beam search: K = 1 against greedy on the same step, K = 4 at x5, x4
    enc, prompt = _bucket_encoder_states(session, audio)
    zero = torch.zeros(dims.vocab_size, device="cuda")
    toks1, _ = beam_generate(session._decoder_params, dims, enc, prompt[0],
                             zero, zero, 128, special.eot, 1,
                             int8_cross_kv=True, packed_cross=True,
                             int8_mxu=True)
    logits, cache = whisper.decoder_prefill(session._decoder_params, dims,
                                            prompt, enc, 132,
                                            int8_cross_kv=True)
    want = [logits[:, -1].float().argmax(-1)]
    done = want[0] == special.eot
    for i in range(1, 128):
        lg, cache = whisper.decoder_step(session._decoder_params, dims,
                                         want[-1], 3 + i, cache,
                                         cross_len=enc.shape[1],
                                         int8_mxu=True)
        want.append(torch.where(done, special.eot, lg.float().argmax(-1)))
        done = done | (want[-1] == special.eot)
    if not torch.equal(toks1, torch.stack(want, dim=1)):
        raise AssertionError("beam K = 1 differs from greedy decoding on "
                             "the same step")
    print(f"[decoding] (d) beam K = 1 equals greedy decoding on its step "
          f"(plain self-attention, B4) for the {enc.shape[0]} rows of the "
          f"bucket, on {card}", flush=True)
    del sessions, session, cache
    for variant, on, off in (("x5", "cross_attend_step",
                              "cross_attend_step_dequant"),
                             ("x4", "cross_attend_step_dequant",
                              "cross_attend_step")):
        session = make_session("cuda", params, variant)
        again, _ = longform(session, num_beams=4)             # and warm-up
        (toks, timing), e2e, c = _decode_run(
            results, lambda: longform(session, num_beams=4))
        # steps run, graphed: a block of 16 past all-done counts too
        steps = c[on] // n_l
        if not (toks.shape == greedy.shape and (again == toks).all()
                and c[on] == steps * n_l > 0 and steps <= 127
                and c[off] == 0 and c["self_attend_step"] == 0):
            raise AssertionError(f"beam K = 4 at {variant}: two runs equal "
                                 f"{bool((again == toks).all())}, launches "
                                 f"{c}")
        print(f"[decoding] (d) beam K = 4, whisper-base {variant}, 64 beam "
              f"rows, on {card}: e2e {e2e:.4f} s, model "
              f"{timing.model_only_s:.4f} s, {steps} steps run (graphed); "
              f"tokens equal to "
              f"greedy x5's: {float((toks == greedy).mean()):.4f} of "
              f"{toks.size}; two runs equal; launches {c}", flush=True)
        del session
    print(f"[decoding] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# The CLI phase's files: (name, seconds, sample rate, channels).  Sorted by
# name, the 4 s file comes first: the warm-up file and the medium run's.
CLI_FILES = (("a_4s.wav", 4.0, 16000, 1),
             ("b_29s5_44k_stereo.wav", 29.5, 44100, 2),
             ("c_76s.wav", 76.0, 16000, 1),       # 7,600 frames: one shot
             ("d_150s.wav", 150.0, 16000, 1))     # streamed slabs
CSV_HEADER = ["file", "duration_s", "end_to_end_s", "rtf", "text"]
DECODING_FLAGS = {"timestamps": ["--timestamps"],
                  "language-auto": ["--language", "auto"],
                  "temperatures": ["--temperatures", "0,0.2,0.4"],
                  "beams": ["--num-beams", "4"]}
SUMMARY_KEYS = {"config_used", "n_files", "latency_end_to_end_s",
                "breakdown_s", "rtf_end_to_end", "model_id", "onnx_dir",
                "language", "task", "max_new_tokens", "tokenizer_json",
                "timestamps", "notes"}


def _write_wav(path: str, seconds: float, sr: int, channels: int) -> None:
    """16-bit PCM WAV of the headline's synthetic signal (the second
    channel at 0.8 of the first)."""
    import struct

    import numpy as np

    from whisper_tpu_torch.headline import synth_audio

    x = synth_audio(seconds, sr=sr)
    x = np.stack([x, 0.8 * x][:channels], axis=1).reshape(-1)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, channels, sr, sr * channels * 2,
                      channels * 2, 16, b"data", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def _one_shot_mels(durations, warmup: int) -> int:
    """B5 launches of one CLI run: one per one-shot mel, that is per warmed
    shape (``warm_buckets``) of a one-shot file, per warm-up run of the
    first file and per one-shot file (at most 7,680 frames)."""
    from whisper_tpu_torch.frontend.golden import num_frames
    from whisper_tpu_torch.pipeline.warmup import _shape_key

    def one_shot(d):
        return int(num_frames(int(round(d * 16000))) <= 7680)

    seen, warmed = set(), 0
    for d in durations:
        key = _shape_key(d, 30.0, 5.0, 16)
        if key not in seen:
            seen.add(key)
            warmed += one_shot(d)
    return warmed + warmup * one_shot(durations[0]) + sum(map(one_shot,
                                                               durations))


def run_cli(label: str, card: str, results, audio_dir: str, out_dir: str,
            args, mel_seconds=None, files=CLI_FILES) -> dict:
    """One in-process run of the benchmark CLI with every kernel count set
    to 0 just before it; checks its outputs and returns the counts.
    mel_seconds: the durations the front end sees, where they are not the
    files' (``--vad-filter``); files: the ``CLI_FILES`` entries the audio
    dir holds, where not the first of them."""
    import csv
    import math

    import torch

    from whisper_tpu_torch.bench.cli import main as cli_main

    out = os.path.join(out_dir, label)
    _zero_counts(results)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rc = cli_main(["--audio-dir", audio_dir, "--onnx-dir",
                   os.path.join(out_dir, "no-model"), "--allow-random-init",
                   "--warmup", "1", "--out-csv", f"{out}/c.csv", "--out-json",
                   f"{out}/j.json", "--out-summary-json", f"{out}/s.json",
                   *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(results)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(os.listdir(audio_dir))
    with open(f"{out}/c.csv") as f:
        table = list(csv.reader(f))
    rows = json.load(open(f"{out}/j.json"))
    summary = json.load(open(f"{out}/s.json"))
    want = [(name, secs) for name, secs, _, _ in files][:n]
    if rc != 0 or table[0] != CSV_HEADER or len(table) != n + 1:
        raise AssertionError(f"{label}: rc {rc}, CSV {table[:1]} with "
                             f"{len(table) - 1} rows, expected {n}")
    if set(summary) != SUMMARY_KEYS or summary["n_files"] != n:
        raise AssertionError(f"{label}: summary keys {sorted(summary)}")
    got = [(r["file"], r["duration_s"]) for r in rows]
    if [(f, round(d, 2)) for f, d in got] != want:
        raise AssertionError(f"{label}: rows {got}, expected {want}")
    e2e = [r["end_to_end_s"] for r in rows]
    if not all(math.isfinite(x) and x > 0 for x in e2e):
        raise AssertionError(f"{label}: per-file e2e {e2e}")
    mels = _one_shot_mels(mel_seconds or [secs for _, secs in want],
                          warmup=1)
    if counts["log_mel"] != mels:
        raise AssertionError(f"{label}: B5 launched {counts['log_mel']} "
                             f"times, expected {mels} (one per one-shot "
                             "mel)")
    p95 = summary["latency_end_to_end_s"]["p95"]
    split = ", ".join(f"{k} {v['median']:.4f}"
                      for k, v in summary["breakdown_s"].items())
    print(f"[cli] {label} on {card}: per-file e2e "
          + ", ".join(f"{f} {x:.4f} s" for (f, _), x in zip(want, e2e))
          + f"; p95 {p95:.4f} s; Timing (median s) {split}; wall "
          f"{wall:.1f} s with warm-up; peak device memory {peak:.3f} GiB, "
          f"{peak - base / 2 ** 30:.3f} above what was allocated at its "
          f"start; launches {counts}", flush=True)
    return counts


def check_cli(card: str, results) -> dict:
    """The CLI at whisper-base x5, int8 and x7 over the four files, then at
    whisper-base x5 with a whisper-tiny draft over the 4 s file (the CLI at
    whisper-medium runs in ``[medium]``); returns each run's counts."""
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        # No tokenizer.json anywhere: rows carry token ids, as in the
        # reference; HF_HOME points the hub-cache lookup into the run.
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        base = ["--model-id", "openai/whisper-base", "--max-new-tokens",
                "128"]
        runs = {
            "whisper-base x5": run_cli("base-x5", card, results, audio_dir,
                                       tmp, base + ["--variant", "x5"]),
            "whisper-base int8": run_cli("base-int8", card, results,
                                         audio_dir, tmp,
                                         base + ["--variant", "int8"]),
            "whisper-base x7": run_cli("base-x7", card, results, audio_dir,
                                       tmp, base + ["--variant", "x7"]),
        }
        # the decoding flags, at 32 tokens a chunk to bound the run time
        for label, flags in DECODING_FLAGS.items():
            runs[f"whisper-base x5 {label}"] = run_cli(
                f"base-x5-{label}", card, results, audio_dir, tmp,
                ["--model-id", "openai/whisper-base", "--max-new-tokens", "32",
                 "--variant", "x5", *flags])
        for name in os.listdir(audio_dir):
            if name != CLI_FILES[0][0]:
                os.remove(os.path.join(audio_dir, name))
        runs["whisper-base x5 draft"] = run_cli(
            "base-x5-draft", card, results, audio_dir, tmp,
            base + ["--variant", "x5", "--draft-model-id",
                    "openai/whisper-tiny", "--draft-k", "4"])
    x5, x4 = runs["whisper-base x5"], runs["whisper-base int8"]
    for label, c, on, off in (("x5", x5, "cross_attend_step",
                               "cross_attend_step_dequant"),
                              ("int8", x4, "cross_attend_step_dequant",
                               "cross_attend_step")):
        if not (c[on] > 0 and c[off] == 0 and c["self_attend_step"] > 0
                and c["fused_attention"] > 0 and c["fused_encoder_mlp"] > 0):
            raise AssertionError(f"CLI {label}: launches {c}")
    x7 = runs["whisper-base x7"]
    if not (x7["self_attend_step_int8"] == x7["cross_attend_step"] > 0
            and x7["self_attend_step"] == 0
            and x7["cross_attend_step_dequant"] == 0
            and x7["fused_attention"] > 0 and x7["fused_encoder_mlp"] > 0):
        raise AssertionError(f"CLI x7: launches {x7}")
    for label in DECODING_FLAGS:
        c = runs[f"whisper-base x5 {label}"]
        step_ok = c["self_attend_step"] == 0 if label == "beams" \
            else c["self_attend_step"] == c["cross_attend_step"]
        if not (c["cross_attend_step"] > 0 and step_ok
                and c["cross_attend_step_dequant"] == 0
                and c["fused_attention"] > 0):
            raise AssertionError(f"CLI x5 {label}: launches {c}")
    dr = runs["whisper-base x5 draft"]
    if not (dr["cross_attend_multi"] > 0 and dr["cross_attend_step"] > 0
            and dr["cross_attend_multi"] % 6 == 0
            and dr["self_attend_step"] == 0 and dr["log_mel"] > 0):
        raise AssertionError(f"CLI x5 with a draft: launches {dr}")
    return runs


def _judge(session_ref, session_var, mel, prompt, ref_rows, var_rows, eot,
           name, mel_var=None):
    """``divergence_report`` on each chunk's pair of chains (one round a
    chunk: the report's rounds suppress earlier rounds' tokens), the
    variant's chunks cut from ``mel_var`` where its mel is its own (another
    upload wire): (divergences, of them tie-flips, max |delta logit| over
    the chains, the largest reference margin at a divergence, the
    divergences that are not tie-flips)."""
    import torch

    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.runtime.generate import strip_generated
    from whisper_tpu_torch.variants.diagnose import divergence_report

    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    var_pad = mel_pad if mel_var is None else torch.nn.functional.pad(
        mel_var, (0, CHUNK_FRAMES))
    divs, d_max = [], 0.0
    for (s0, pr), ref, var in zip(prompt, ref_rows, var_rows):
        c_ref, c_var = strip_generated(ref, eot), strip_generated(var, eot)
        if c_ref == c_var:
            continue
        chunk = mel_pad[:, s0:s0 + CHUNK_FRAMES]
        diag = divergence_report(name, session_ref, session_var, chunk,
                                 var_pad[:, s0:s0 + CHUNK_FRAMES], pr,
                                 [c_ref], [c_var], eot_id=eot)
        divs += diag.divergences
        d_max = max(d_max, diag.max_dlogit_chain)
    flips = sum(d.tie_flip for d in divs)
    margin = max((d.x0_margin for d in divs), default=0.0)
    return len(divs), flips, d_max, margin, [d for d in divs
                                             if not d.tie_flip]


def _judge_line(verdict) -> str:
    """A ``_judge`` result as a line's words."""
    from whisper_tpu_torch.variants.diagnose import KERNEL_EPS

    n_div, flips, d_max, margin, drift = verdict
    return (f"{n_div} chunks diverge, {flips} tie-flips (largest reference "
            f"margin at a divergence {margin:.4f}, KERNEL_EPS {KERNEL_EPS}); "
            f"max_dlogit_chain {d_max:.4f}; not tie-flips: "
            + ("; ".join(f"step {d.step}: {d.x0_token} -> {d.var_token}, "
                         f"margin {d.x0_margin:.4f}, variant margin "
                         f"{d.var_margin:.4f}" for d in drift) or "none"))


def _parse_cues(path: str) -> list:
    """(start s, end s, text) of every cue of an .srt or .vtt file."""
    import re

    stamp = r"(\d+):(\d\d):(\d\d)[,.](\d\d\d)"
    cues = []
    for line in open(path).read().splitlines():
        m = re.fullmatch(stamp + r" --> " + stamp, line)
        if m:
            g = [int(x) for x in m.groups()]
            cues.append([g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000,
                         g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000, ""])
        elif cues and line.strip() and not line.isdigit():
            cues[-1][2] += line
    return cues


def check_prompts_words(card: str, results, params, dims, audio,
                        judged) -> None:
    """Conditioned prompts, the sequential mode, word timings and the
    quality judge at whisper-base, each result on a ``[prompts]`` line:
    (a) the 301.574 s file's bucket of 16 decoded at x5 (B3) and x7 (B8)
    with ``[<|startofprev|>] + tail`` left-padded to 64 slots (three pad
    counts across rows), against the same rows decoded with each row's
    unpadded prompt: every first divergence judged by ``divergence_report``
    and any that is not a tie-flip fails the phase; B3 and B8 launched
    with a ``pad_count``; (b) the sequential mode at x5 and x7 on the 76 s
    file, conditioned on the previous text with an initial prompt, twice
    (equal); (c) word timings at x5, chunked and sequential: rows of the
    alignment sum to 1, words monotone within each chunk and inside the
    file, the card's words within 0.02 s of the port on the CPU for one
    chunk; (d) the judge on ``judged`` ({name: (reference tokens, variant
    tokens)} of the 301 s file's chunks: x7 against x5, speculative
    against greedy), printed, never failing; (e) the CLI over the four
    files with ``--longform-mode sequential --condition-on-prev-text``,
    ``--word-timestamps --write-srt --write-vtt`` and ``--vad-filter
    --word-timestamps``."""
    import numpy as np
    import torch

    from whisper_tpu_torch.audio.io import load_audio_16k_mono
    from whisper_tpu_torch.audio.vad import (
        VadOptions,
        collect_chunks,
        detect_speech,
    )
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.ops import self_attention
    from whisper_tpu_torch.pipeline.chunk import (
        CHUNK_FRAMES,
        chunk_starts,
        mel_frame_bucket,
    )
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.pipeline.sequential import transcribe_sequential
    from whisper_tpu_torch.pipeline.words import align_chunk_words
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.generate import (
        greedy_generate,
        strip_generated,
    )
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    t_phase = time.perf_counter()
    n_e = dims.encoder_layers
    special = special_tokens("en", "transcribe", None)
    eot = special.eot
    base = [special.sot, special.lang, special.task, special.no_timestamps]
    gen_cfg = GenerationCfg()
    rng = np.random.default_rng(13)
    prev = [special.sot_prev] + rng.integers(220, 50000, 63).tolist()
    prompt = prev + base                                      # 68 slots
    sessions = {v: make_session("cuda", params, v) for v in ("x5", "x7")}

    # (a) padded against unpadded, through B3 (x5) and B8 (x7)
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    n = len(starts)
    for variant, session in sessions.items():
        enc, _ = _bucket_encoder_states(session, audio)
        b = enc.shape[0]
        pads = [(5, 21, 40)[r % 3] for r in range(b)]
        masks = session._get_masks(gen_cfg.suppress_tokens,
                                   gen_cfg.begin_suppress_tokens)
        x7 = variant == "x7"

        def decode(rows, row_prompt, pad_count=None):
            return greedy_generate(
                session._decoder_params, dims, enc[rows],
                torch.tensor(row_prompt, device=enc.device), *masks, 128, eot,
                int8_cross_kv=True, kernel_step=True, int8_mxu=True,
                int8_self=x7, pad_count=pad_count).cpu().numpy()

        self_attention.padded_launches = 0
        self_attention.int8_padded_launches = 0
        (padded, secs, c) = _decode_run(results, lambda: decode(
            list(range(b)), prompt,
            torch.tensor(pads, dtype=torch.int32, device=enc.device)))
        launched = (self_attention.int8_padded_launches if x7
                    else self_attention.padded_launches)
        kernel = "self_attend_step_int8" if x7 else "self_attend_step"
        if not 0 < launched == c[kernel]:
            raise AssertionError(f"(a) {variant}: {launched} launches with a "
                                 f"pad_count of {c[kernel]}")
        unpadded = np.empty_like(padded)
        for pad in sorted(set(pads)):
            rows = [r for r in range(b) if pads[r] == pad]
            unpadded[rows] = decode(rows, prompt[pad:])
        nv = golden.num_frames(len(audio))
        mel = session.compute_mel(golden.reflect_pad(audio), nv,
                                  mel_frame_bucket(nv))
        same = float((padded[:n] == unpadded[:n]).mean())
        n_div, flips, d_max, _, drift = _judge(
            session, session, mel, [(s, prompt[pads[r]:])
                                    for r, s in enumerate(starts)],
            unpadded[:n], padded[:n], eot, f"padded {variant}")
        print(f"[prompts] (a) whisper-base {variant}, {b} rows, prompt of "
              f"{len(prompt)} slots left-padded by {sorted(set(pads))}, on "
              f"{card}: {secs:.4f} s padded; tokens equal to the unpadded "
              f"prompts': {same:.4f} of {padded[:n].size}; {n_div} first "
              f"divergences, {flips} tie-flips (max |dlogit| {d_max:.4f}); "
              f"{'B8' if x7 else 'B3'} launched {launched} times with a "
              f"pad_count", flush=True)
        if drift:
            raise AssertionError(f"(a) {variant}: divergences that are not "
                                 f"tie-flips: {drift}")

    # (b) the sequential mode, conditioned, with an initial prompt
    audio76 = synth_audio(76.0)
    init_ids = rng.integers(220, 50000, 12).tolist()
    seq = {}
    for variant, session in sessions.items():
        runs = []
        for _ in range(2):
            self_attention.padded_launches = 0
            self_attention.int8_padded_launches = 0
            (text, segs, timing), e2e, c = _decode_run(
                results, lambda: transcribe_sequential(
                    session, audio76, "en", "transcribe", 128,
                    condition_on_prev_text=True,
                    initial_prompt_ids=init_ids))
            padded_launches = (self_attention.int8_padded_launches
                               if variant == "x7"
                               else self_attention.padded_launches)
            runs.append(([s.tokens for s in segs], segs, e2e, timing, c,
                         padded_launches))
        toks, segs, e2e, timing, c, padded_launches = runs[1]
        windows = c["fused_attention"] // n_e
        starts_s = [s.start_s for s in segs]
        past = sum(s.end_s > 76.0 for s in segs)
        # Segments start in order, inside the windows the seek loop
        # opened (each starts before 76 s): the grammar has no rule on the
        # audio's end, so with random weights a closed segment of the last
        # window can end, or start, past the file, in the JAX package alike.
        ok = (runs[0][0] == toks and segs and windows < 1000
              and starts_s == sorted(starts_s) and starts_s[0] >= 0.0
              and starts_s[-1] < 76.0 + 30.0 and padded_launches > 0)
        print(f"[prompts] (b) sequential, whisper-base {variant}, 76 s, "
              f"conditioned on the previous text with a 12-token initial "
              f"prompt, on {card}: {windows} windows, {len(segs)} segments "
              f"({past} ending past the file), e2e {e2e:.4f} s, model "
              f"{timing.model_only_s:.4f} s; two runs equal "
              f"{runs[0][0] == toks}; {padded_launches} launches with a "
              f"pad_count; launches {c}", flush=True)
        if not ok:
            raise AssertionError(f"(b) {variant}: segments "
                                 f"{[(s.start_s, s.end_s) for s in segs]}")
        seq[variant] = (segs, timing)

    # (c) word timings at x5, chunked and sequential
    session = sessions["x5"]
    nv = golden.num_frames(len(audio76))
    mel = session.compute_mel(golden.reflect_pad(audio76), nv,
                              mel_frame_bucket(nv))
    mel_pad = torch.nn.functional.pad(mel, (0, CHUNK_FRAMES))
    tokens, words = [], []
    _, timing = transcribe_longform(session, audio76, "en", "transcribe", 128,
                                    token_collector=tokens,
                                    word_collector=words)
    starts76 = [p // golden.HOP for p in chunk_starts(len(audio76), 480_000,
                                                      400_000)]
    def word_err(got, want):
        """The largest start or end difference of two equal word lists."""
        if [x.word for x in got] != [x.word for x in want]:
            raise AssertionError("(c) the card's words are not the CPU's")
        return max((max(abs(a.start_s - b.start_s), abs(a.end_s - b.end_s))
                    for a, b in zip(got, want)), default=0.0)

    per_chunk = []
    for i, row in enumerate(tokens[0]):
        gen = [t for t in strip_generated(row, eot)
               if t <= special.no_timestamps]
        chunk = mel_pad[:, starts76[i]:starts76[i] + CHUNK_FRAMES]
        kw = dict(offset_s=starts76[i] * 0.01,
                  audio_len_s=min(30.0, (nv - starts76[i]) * 0.01))
        per_chunk.append(align_chunk_words(session, chunk, base, gen, **kw))
        if i == 0:
            gen0, chunk0, kw0 = gen, chunk, kw
    w = session.alignment_weights(chunk0, base, gen0)
    row_err = float(np.abs(w.sum(-1) - 1.0).max())
    # The card against the port on the CPU, chunk 0's tokens teacher-forced:
    # at x5 (bf16: the encoders agree within a few bf16 steps, and on random
    # weights the attention over 1,500 frames is nearly flat, so DTW's path
    # may move with them) as information, and held at x0 (fp32).
    cpu = make_session("cpu", params, "x5")
    w_err = float(np.abs(w - cpu.alignment_weights(chunk0.cpu(), base,
                                                   gen0)).max())
    x5_err = word_err(per_chunk[0], align_chunk_words(cpu, chunk0.cpu(), base,
                                                      gen0, **kw0))
    card0 = make_session("cuda", params, "x0")
    cpu0 = make_session("cpu", params, "x0")
    cpu_err = word_err(
        align_chunk_words(card0, chunk0, base, gen0, **kw0),
        align_chunk_words(cpu0, chunk0.cpu(), base, gen0, **kw0))
    del cpu, card0, cpu0
    flat = [x.to_dict() for c_ in per_chunk for x in c_]
    monotone = all(a.start_s <= b.start_s and a.start_s <= a.end_s
                   for c_ in per_chunk for a, b in zip(c_, c_[1:] + c_[-1:]))
    inside = all(0.0 <= x.start_s <= x.end_s <= 76.0 + 1e-6
                 for c_ in per_chunk for x in c_)
    seq_words, marks = [], []
    transcribe_sequential(session, audio76, "en", "transcribe", 128,
                          word_collector=seq_words,
                          segment_callback=lambda _: marks.append(
                              len(seq_words)))
    windows = [seq_words[a:b] for a, b in zip([0] + marks, marks)]
    seq_ok = all(0.0 <= x["start"] <= x["end"] <= 76.0 + 1e-6
                 for x in seq_words) and all(
        a["start"] <= b["start"] for w_ in windows for a, b in zip(w_,
                                                                 w_[1:]))
    print(f"[prompts] (c) word timings, whisper-base x5, 76 s, on {card}: "
          f"chunked {len(words)} words in {len(per_chunk)} chunks "
          f"(transcribe_longform's list equal to the chunks' {flat == words}), "
          f"rows of the alignment within {row_err:.2e} of 1, monotone within "
          f"each chunk {monotone}, inside the file {inside}; chunk 0 against "
          f"the CPU: "
          f"x0 (fp32) words within {cpu_err:.4f} s, x5 alignment weights "
          f"within {w_err:.3g} and words within {x5_err:.4f} s; sequential "
          f"{len(seq_words)} words in {len(windows)} windows, monotone and "
          f"inside {seq_ok}; chunked e2e {timing.end_to_end_s:.4f} s "
          f"(alignment in decode_s {timing.decode_s:.4f} s)", flush=True)
    if not (row_err <= 1e-3 and monotone and inside and seq_ok
            and flat == words and words and cpu_err <= 0.02):
        raise AssertionError("(c) word timings fail their checks")

    # (d) the judge on the open items of ROADMAP queue 3
    del sessions
    nv = golden.num_frames(len(audio))
    for name, (ref, var) in judged.items():
        variant = "x4" if "x4" in name else "x5"
        s_ref = make_session("cuda", params, variant)
        s_var = make_session("cuda", params, "x7") if "x7" in name else s_ref
        mel = s_ref.compute_mel(golden.reflect_pad(audio), nv,
                                mel_frame_bucket(nv))
        verdict = _judge(s_ref, s_var, mel, [(s, base) for s in starts],
                         ref, var, eot, name)
        print(f"[prompts] (d) judge, {name}, whisper-base, 301.574 s, on "
              f"{card}: tokens equal {float((ref == var).mean()):.4f} of "
              f"{ref.size}; " + _judge_line(verdict), flush=True)
        del s_ref, s_var

    # (e) the CLI with each new flag over the four files
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        condensed = [len(collect_chunks(a, detect_speech(a, VadOptions()))[0])
                     / 16000.0 for a in (
            load_audio_16k_mono(os.path.join(audio_dir, f))[0]
            for f, _, _, _ in CLI_FILES)]
        base_args = ["--model-id", "openai/whisper-base", "--max-new-tokens",
                     "32", "--variant", "x5"]
        for label, flags in (
                ("sequential", ["--longform-mode", "sequential",
                                "--condition-on-prev-text"]),
                ("words", ["--word-timestamps", "--write-srt",
                           "--write-vtt"]),
                ("vad", ["--vad-filter", "--word-timestamps"])):
            self_attention.padded_launches = 0
            c = run_cli(f"base-x5-{label}", card, results, audio_dir, tmp,
                        base_args + flags,
                        mel_seconds=condensed if label == "vad" else None)
            out = os.path.join(tmp, f"base-x5-{label}")
            rows = json.load(open(f"{out}/j.json"))
            if label == "sequential":
                ok = self_attention.padded_launches > 0
                note = (f"{self_attention.padded_launches} B3 launches with "
                        "a pad_count")
            else:
                ok = all(isinstance(r.get("words"), list) for r in rows) \
                    and any(r["words"] for r in rows)
                note = f"{sum(len(r['words']) for r in rows)} words"
            if label == "words":
                # Cues follow the words, chunk after chunk: in order within
                # a chunk, and at most one step back where the next chunk's
                # 5 s overlap begins (the JAX CLI's cues alike).
                backs = []
                for name, secs, _, _ in CLI_FILES:
                    stem = os.path.splitext(name)[0]
                    srt, vtt = (_parse_cues(f"{out}/{stem}.{ext}")
                                for ext in ("srt", "vtt"))
                    n_chunks = len(chunk_starts(int(secs * 16000), 480_000,
                                                400_000))
                    back = sum(b[0] < a[0] for a, b in zip(srt, srt[1:]))
                    backs.append(back)
                    ok = ok and bool(srt) and srt == vtt \
                        and back < n_chunks and all(
                            0.0 <= c[0] and c[1] <= secs + 0.5 for c in srt)
                note += (f"; every .srt and .vtt parses (equal cues), in "
                         f"order within each chunk (steps back at chunk "
                         f"overlaps by file: {backs})")
            print(f"[prompts] (e) CLI {label}: {note}; launches {c}",
                  flush=True)
            if not ok or c["self_attend_step"] == 0:
                raise AssertionError(f"(e) CLI {label}: {note}, launches "
                                     f"{c}")
    print(f"[prompts] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _engine_tokens(text: str) -> list:
    """The generated ids of a tokenizer-less engine text ("[TOKENS:a b]")."""
    if not text:
        return []
    if not (text.startswith("[TOKENS:") and text.endswith("]")):
        raise AssertionError(f"not a tokenizer-less engine text: {text!r}")
    return [int(t) for t in text[len("[TOKENS:"):-1].split()]


def _serve_clips(n: int, seed: int, lo: float = 1.0, hi: float = 30.0):
    """n synthetic clips of lo..hi seconds (a tone and noise each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    secs = rng.uniform(lo, hi, n)
    secs[0], secs[-1] = lo, hi        # both ends of the range
    out = []
    for i, s in enumerate(secs):
        t = np.arange(int(s * 16000)) / 16000.0
        out.append((0.1 * np.sin(2 * np.pi * (150 + 23 * i) * t)
                    + 0.03 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def _one_row(clip):
    """A clip as the engine ships it alone: (its reflect-padded row in the
    full 30 s window [1, 480,400], its valid frames [1])."""
    import numpy as np

    from whisper_tpu_torch.frontend import golden

    pad = golden.reflect_pad(clip)
    row = np.zeros((1, 480_000 + 400), dtype=np.float32)
    row[0, :len(pad)] = pad
    return row, np.array([golden.num_frames(len(clip))], np.int32)


def _judge_rows(session, clips, prompt, eot, got_rows, want_rows,
                label: str) -> str:
    """Rows of two runs of the same clips: equal, or each first divergence
    judged by ``_judge`` on the clip's own short-path mel (both chains
    teacher-forced through ``session``); one that is not a tie-flip fails.
    Returns a summary."""
    import numpy as np

    n_div = flips = 0
    for clip, got, want in zip(clips, got_rows, want_rows):
        if got == want:
            continue
        mel = session._short_mel(*_one_row(clip))[0]
        d, f, _, _, bad = _judge(session, session, mel, [(0, prompt)],
                                 [np.array(want)], [np.array(got)], eot,
                                 label)
        if bad:
            raise AssertionError(f"{label}: a divergence that is not a "
                                 f"tie-flip: {bad}")
        n_div, flips = n_div + d, flips + f
    same = sum(g == w for g, w in zip(got_rows, want_rows))
    return (f"{same} of {len(got_rows)} rows equal, {n_div} divergences, "
            f"{flips} tie-flips")


def _latencies(engine, clips):
    """Submit every clip at once; (texts, seconds from the submit to each
    future's end).  A future holding an exception raises here."""
    t0 = time.perf_counter()
    done = {}
    futs = []
    for i, c in enumerate(clips):
        f = engine.submit(c)
        f.add_done_callback(lambda _, i=i: done.__setitem__(
            i, time.perf_counter()))
        futs.append(f)
    texts = [f.result(timeout=600) for f in futs]
    return texts, [done[i] - t0 for i in range(len(clips))]


def _pct(lat, q: float) -> float:
    """serve_bench's nearest-rank percentile of a list of latencies."""
    from whisper_tpu_torch.serve.serve_bench import percentile

    return percentile(sorted(lat), q)


def check_serve(card: str, results, params, dims) -> None:
    """The serving path at whisper-base (``[serve]`` lines): the engine's
    short lane at x4 (the server's default) and x5, its long lane, the TCP
    server and the router, the OpenAI HTTP API, the speculative leg and
    the load of 64 streams, then the card test of two threads launching B3
    and B8 at once in a fresh process.  Every future's result is read (an
    exception fails the phase); each lane's kernels must have launched."""
    import asyncio
    import base64
    import socket
    import subprocess
    import threading
    import urllib.request

    import numpy as np

    from whisper_tpu_torch.headline import make_session, synth_audio
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.generate import strip_generated
    from whisper_tpu_torch.serve import serve_bench
    from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
    from whisper_tpu_torch.serve.http_server import (
        TranscriptionService,
        make_server,
    )
    from whisper_tpu_torch.serve.router import serve_router
    from whisper_tpu_torch.serve.server import serve
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params

    t_phase = time.perf_counter()
    special = special_tokens("en", "transcribe", None)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    eot = special.eot
    gen = GenerationCfg()
    clips = _serve_clips(16, seed=14)

    def alone(session, clip):
        """The clip by itself through the session's short path (bucket 1,
        the full window)."""
        toks = session.transcribe_short_batch(
            *_one_row(clip), prompt, 128, eot,
            suppress_ids=gen.suppress_tokens,
            begin_suppress_ids=gen.begin_suppress_tokens)
        return strip_generated(toks[0], eot)

    # (a) the short lane: a burst of 16 clips against each clip alone
    engines, burst = {}, {}
    for rung, cross in (("x4", "cross_attend_step_dequant"),
                        ("x5", "cross_attend_step")):
        session = make_session("cuda", params, rung)
        eng = StreamingEngine(session, cfg=EngineConfig(
            max_new_tokens=128, batch_window_ms=20))
        engines[rung] = eng
        eng.warmup(batch=16)
        ticks = eng.stats["batches"]
        _zero_counts(results)
        t0 = time.perf_counter()
        texts, lat = _latencies(eng, clips)
        wall = time.perf_counter() - t0
        c = _counts(results)
        ticks = eng.stats["batches"] - ticks
        rows = [_engine_tokens(t) for t in texts]
        burst[rung] = rows
        need = ("fused_attention", "fused_encoder_mlp", "self_attend_step",
                cross)
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(a) {rung} short lane: launches {c}")
        verdict = _judge_rows(session, clips, prompt, eot,
                              rows, [alone(session, a) for a in clips],
                              f"(a) {rung} batched against alone")
        # trimmed against full-width uploads: four clips under 1/8 window
        short = _serve_clips(4, seed=15, lo=1.0, hi=3.5)
        trimmed = [f.result(timeout=600) for f in
                   [eng.submit(a) for a in short]]
        eng.cfg.trim_upload = False
        widths = [f.result(timeout=600) for f in
                  [eng.submit(a) for a in short]]
        eng.cfg.trim_upload = True
        if trimmed != widths:
            raise AssertionError(f"(a) {rung}: trimmed uploads give other "
                                 "tokens than full-width ones")
        print(f"[serve] (a) short lane {rung}, 16 clips of 1-30 s, on {card}:"
              f" {ticks} tick(s), wall {wall:.4f} s, "
              f"latency p50 {_pct(lat, 0.5):.4f} s p95 "
              f"{_pct(lat, 0.95):.4f} s; "
              f"{verdict} against each clip alone at bucket 1; trimmed "
              f"uploads equal full-width ones (4 clips of 1-3.5 s); "
              f"launches {c}", flush=True)
    x4 = engines["x4"]

    # (b) the long lane: a 76 s file while 16 short clips are in flight
    long_audio = synth_audio(76.0)
    _, lat_alone = _latencies(x4, clips)
    done = {}
    t0 = time.perf_counter()
    shorts = []
    for i, c in enumerate(clips):
        f = x4.submit(c)
        f.add_done_callback(lambda _, i=i: done.__setitem__(
            i, time.perf_counter()))
        shorts.append(f)
    # Past the coalescing window, the tick of 16 decodes (~1 s on the card)
    # when the long request arrives on its own lane.
    time.sleep(0.3)
    n_long = x4.stats["longform"]
    _zero_counts(results)
    long_fut = x4.submit(long_audio)
    long_fut.add_done_callback(lambda _: done.__setitem__(
        "long", time.perf_counter()))
    for f in shorts:
        f.result(timeout=600)
    long_text = long_fut.result(timeout=600)
    c = _counts(results)
    if c["log_mel"] != 1 or c["cross_attend_step_dequant"] == 0:
        raise AssertionError(f"(b) lanes: launches {c}")
    if max(done[i] for i in range(16)) > done["long"]:
        raise AssertionError("(b) the long request resolved before the "
                             "short ones")
    want, _ = transcribe_longform(x4.session, long_audio, "en", "transcribe",
                                  128, 30.0, 5.0, None, False, gen)
    if long_text != want or x4.stats["longform"] != n_long + 1:
        raise AssertionError("(b) the long lane's text is not the long-form "
                             "text of the file alone")
    lat_long = [done[i] - t0 for i in range(16)]
    print(f"[serve] (b) long lane x4, 76 s beside 16 short clips, on {card}: "
          f"shorts done {max(lat_long):.4f} s, the long request "
          f"{done['long'] - t0:.4f} s after the burst; its text equals "
          f"transcribe_longform alone; short-lane p95 "
          f"{_pct(lat_long, 0.95):.4f} s with the long request, "
          f"{_pct(lat_alone, 0.95):.4f} s without; launches "
          f"of both lanes {c} (B5 once: the long file's one-shot mel)",
          flush=True)

    # (c) the TCP server, then the router in front of it
    def run_loop(coro_fn):
        ready, holder = threading.Event(), {}

        def target():
            async def main_():
                class Ev:
                    def set(self):
                        ready.set()

                holder["loop"] = asyncio.get_running_loop()
                holder["task"] = asyncio.current_task()
                try:
                    await coro_fn(Ev())
                except asyncio.CancelledError:
                    pass

            asyncio.run(main_())

        th = threading.Thread(target=target, daemon=True)
        th.start()
        if not ready.wait(30):
            raise AssertionError("(c) a server did not start")

        def stop():
            holder["loop"].call_soon_threadsafe(holder["task"].cancel)
            th.join(timeout=30)

        return stop

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def ask(port, payload):
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            s.settimeout(300)
            s.sendall((json.dumps(payload) + "\n").encode())
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 20)
                if not chunk:
                    break
                buf += chunk
        return json.loads(buf)

    pcm = [(np.clip(a, -1, 1) * 32767).astype("<i2") for a in clips]
    reqs = [{"id": f"r{i}", "pcm16_b64": base64.b64encode(p.tobytes())
             .decode()} for i, p in enumerate(pcm)]

    def four_clients(port):
        out, errors = {}, []

        def client(k):
            try:
                for r in reqs[4 * k:4 * k + 4]:
                    out[r["id"]] = ask(port, r)
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(repr(e))

        ths = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=600)
        if errors or len(out) != 16:
            raise AssertionError(f"(c) clients: {errors or sorted(out)}")
        for r in reqs:
            resp = out[r["id"]]
            if "error" in resp or set(resp) != {"id", "text", "latency_s"}:
                raise AssertionError(f"(c) response {resp}")
        return [_engine_tokens(out[r["id"]]["text"]) for r in reqs]

    port = free_port()
    stop_server = run_loop(lambda ev: serve(x4, "127.0.0.1", port, ev))
    try:
        t0 = time.perf_counter()
        direct = four_clients(port)
        t_direct = time.perf_counter() - t0
        stats = ask(port, {"id": "s", "stats": True})
        if set(stats["stats"]) < {"batches", "batched_requests", "longform"}:
            raise AssertionError(f"(c) stats {stats}")
        rport = free_port()
        stop_router = run_loop(lambda ev: serve_router(
            [("127.0.0.1", port)], "127.0.0.1", rport, ev))
        try:
            t0 = time.perf_counter()
            routed = four_clients(rport)
            t_routed = time.perf_counter() - t0
            merged = ask(rport, {"id": "m", "stats": True})["stats"]
        finally:
            stop_router()
    finally:
        stop_server()
    decoded = [p.astype(np.float32) / 32768.0 for p in pcm]
    verdict = _judge_rows(x4.session, decoded, prompt, eot, routed, direct,
                          "(c) router against server")
    print(f"[serve] (c) TCP x4, 4 clients x 4 requests, on {card}: "
          f"{t_direct:.4f} s through the server, {t_routed:.4f} s through "
          f"the router; router answers against the server's: {verdict}; "
          f"stats {stats['stats']}; router's merged backends "
          f"{len(merged['backends'])}", flush=True)

    # (d) the OpenAI HTTP API
    service = TranscriptionService(x4, "openai/whisper-base")
    httpd = make_server(service, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def wav(audio):
            import struct

            data = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
            return struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE",
                b"fmt ", 16, 1, 1, 16000, 32000, 2, 16, b"data",
                len(data)) + data

        def post(fields, audio):
            b = "servephaseboundary"
            parts = [(f"--{b}\r\nContent-Disposition: form-data; name="
                      f"\"{k}\"\r\n\r\n{v}\r\n").encode()
                     for k, vs in fields.items()
                     for v in (vs if isinstance(vs, list) else [vs])]
            parts.append((f"--{b}\r\nContent-Disposition: form-data; name="
                          "\"file\"; filename=\"a.wav\"\r\n\r\n").encode()
                         + wav(audio) + b"\r\n" + f"--{b}--\r\n".encode())
            req = urllib.request.Request(
                url + "/v1/audio/transcriptions", data=b"".join(parts),
                headers={"Content-Type": f"multipart/form-data; boundary={b}"},
                method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                body = r.read().decode()
                return (r.status, r.headers["Content-Type"], body,
                        time.perf_counter() - t0)

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return json.loads(r.read())

        if get("/healthz") != {"status": "ok"}:
            raise AssertionError("(d) /healthz")
        models = get("/v1/models")
        if models["data"][0]["id"] != "openai/whisper-base":
            raise AssertionError(f"(d) /v1/models {models}")
        clip = clips[3]
        took = {}
        _zero_counts(results)
        st, ct, body, took["json"] = post({"response_format": "json"}, clip)
        if st != 200 or set(json.loads(body)) != {"text"}:
            raise AssertionError(f"(d) json: {st} {body[:200]}")
        st, ct, body, took["srt"] = post({"response_format": "srt"}, clip)
        if st != 200 or "-->" not in body or not ct.startswith("text/plain"):
            raise AssertionError(f"(d) srt: {st} {body[:200]}")
        st, ct, body, took["verbose_json"] = post(
            {"response_format": "verbose_json",
             "timestamp_granularities[]": ["word", "segment"]}, clip)
        out = json.loads(body)
        if st != 200 or set(out) != {"task", "language", "duration", "text",
                                     "segments", "words"} \
                or not out["words"] or not out["segments"]:
            raise AssertionError(f"(d) verbose_json: {st} {body[:300]}")
        st, ct, body, took["sse"] = post({"stream": "true"}, clip)
        events = [json.loads(line[6:]) for line in body.splitlines()
                  if line.startswith("data: ")]
        if st != 200 or not ct.startswith("text/event-stream") or not events \
                or events[-1]["type"] != "transcript.text.done":
            raise AssertionError(f"(d) sse: {st} {body[:300]}")
        c = _counts(results)
        if c["fused_attention"] == 0 or c["self_attend_step"] == 0:
            raise AssertionError(f"(d) HTTP lanes: launches {c}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    print(f"[serve] (d) HTTP x4, a {len(clip) / 16000:.2f} s upload, on "
          f"{card}: json (short lane) {took['json']:.4f} s, srt "
          f"{took['srt']:.4f} s, verbose_json with {len(out['words'])} words "
          f"{took['verbose_json']:.4f} s (direct lane), SSE "
          f"{len(events)} events {took['sse']:.4f} s; /healthz, /v1/models; "
          f"launches {c}", flush=True)

    # (e) the speculative leg: whisper-base's own int8 weights as draft
    spec_session = make_session("cuda", params, "x5")
    spec_session.set_draft_model(quantize_params(params), dims,
                                 share_encoder=True)
    spec = StreamingEngine(spec_session, cfg=EngineConfig(
        max_new_tokens=128, batch_window_ms=20))
    try:
        _zero_counts(results)
        t0 = time.perf_counter()
        texts, _ = _latencies(spec, clips)
        wall = time.perf_counter() - t0
        c = _counts(results)
        if c["cross_attend_multi"] == 0 or spec.stats["speculative"] != 16:
            raise AssertionError(f"(e) speculative leg: launches {c}, "
                                 f"stats {spec.stats}")
        verdict = _judge_rows(spec_session, clips, prompt, eot,
                              [_engine_tokens(t) for t in texts],
                              burst["x5"], "(e) speculative against greedy")
    finally:
        spec.close()
    print(f"[serve] (e) speculative leg x5, own int8 weights as draft, 16 "
          f"clips, on {card}: wall {wall:.4f} s; against the greedy x5 "
          f"burst: {verdict}; launches {c}", flush=True)

    # (f) a lone 5 s request three times, then the load: 64 streams of 30 s,
    # three repetitions
    x5 = engines["x5"]
    lone = []
    for _ in range(3):
        lone += _latencies(x5, serve_bench.make_streams(1, 5.0))[1]
    print(f"[serve] (f) a lone 5 s request, x5, on {card}: "
          f"{', '.join(f'{t:.4f}' for t in lone)} s", flush=True)
    streams = serve_bench.make_streams(64, 30.0)
    reps = serve_bench.run_bench(x5, streams, reps=3)
    for i, r in enumerate(reps):
        print(f"[serve] (f) load x5, 64 streams x 30 s, rep {i}, on {card}: "
              f"wall {r['wall_s']:.4f} s, {r['x_real_time']:.2f}x real time "
              f"aggregate, latency p50 {r['p50_s']:.4f} s p95 "
              f"{r['p95_s']:.4f} s max {r['max_s']:.4f} s, ticks so far "
              f"{r['ticks']}", flush=True)
    for eng in engines.values():
        eng.close()

    # the two-thread launch test, in a fresh process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "cuda",
         "tests/test_torch_cuda.py::"
         "test_b3_b8_two_threads_raise_the_limit_at_once"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0 or " passed" not in proc.stdout:
        raise AssertionError(f"two-thread launch test: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    print(f"[serve] two threads launching B3 and B8 across 48 KB at once: "
          f"passed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[serve] phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _pipelined_windows(session, audio, slab_chunks: int):
    """The pipelined mode's front end replayed on its own: per slab
    of ``pipelined._slab_plan`` its raw log-spec on the card, and each
    chunk's normalized window (``session.chunk_norm_window``).  Returns
    (raw slabs, [(n_valid, local starts)], windows [n_chunks] of
    [n_mels, 3000])."""
    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.frontend.mel import log_spec_slab
    from whisper_tpu_torch.pipeline import pipelined
    from whisper_tpu_torch.pipeline.chunk import chunk_starts

    padded = golden.reflect_pad(audio)
    total = golden.num_frames(len(audio))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    cap, plan = pipelined._slab_plan(starts, total, slab_chunks)
    slabs, geometry, windows = [], [], []
    for f0, n_valid, local in plan:
        enc = session._upload(session.encode_host_slab(
            padded, f0 * golden.HOP, (cap + 2) * golden.HOP))
        ls, _ = log_spec_slab(enc, n_valid, n_mels=session.dims.n_mels,
                              n_frames=cap)
        slabs.append(ls)
        geometry.append((n_valid, local))
        windows += [session.chunk_norm_window(ls, s, n_valid) for s in local]
    return slabs, geometry, windows


def check_pipelined(card: str, results, params, dims, audio) -> dict:
    """The pipelined long-form mode at whisper-base, 128 tokens
    (``[pipelined]`` lines): (a) the 301.574 s file at x5 through
    ``transcribe_longform_pipelined`` at ``slab_chunks`` 4 and 16, a
    warm-up and a run each, counts set to 0 just before the run and read
    just after: B1, B2, B3 and B4 launched, B5 not (the slab front end is
    the plain ``log_spec_slab``, as in JAX); the rows of slab 4 against
    slab 16's, every first divergence judged by ``divergence_report`` on the
    chunk-normalized windows (one that is not a tie-flip fails); (b)
    ``chunk_norm_window`` on the card against a numpy evaluation of the
    same raw slab copied to the host at frame 0, mid-file and n_valid - 100
    (atol 1e-6), and ``chunk_norm`` on a ragged bucket's padding rows (all
    zeros, finite); (c) speculative over pipelined, x5 with its own int8
    weights as draft: B7 launched, rows against greedy pipelined's, every
    divergence a tie-flip; (d) the converter with neither jax nor the
    ``safetensors`` package: ``save_params`` then ``load_params`` value for
    value, the CLI at x5 from that dir on the 4 s file with the in-memory
    session's text, ``quantize_model_dir`` and the CLI ``--variant int8``
    from the int8 dir with the text of a session that quantizes in memory,
    B6 launched; (e) ``bench.discover`` on 60 s of synthetic audio over x4,
    x5 and x7 with one run each, then the CLI with its JSON, the winner's
    kernels launched; (f) the CLI with ``--longform-mode pipelined`` over
    ``check_cli``'s four files at x5, plain and with ``--word-timestamps
    --language auto``, then ``results.summarize`` and
    ``results.accumulate`` over its output (one timed summary row).
    Returns the launch counts of (a) at slab 4."""
    import numpy as np
    import torch

    from whisper_tpu_torch.audio.io import load_audio_16k_mono
    from whisper_tpu_torch.bench import discover
    from whisper_tpu_torch.bench.cli import main as cli_main
    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.models import convert
    from whisper_tpu_torch.pipeline.chunk import CHUNK_FRAMES
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.pipeline.pipelined import (
        transcribe_longform_pipelined,
    )
    from whisper_tpu_torch.results import accumulate, summarize
    from whisper_tpu_torch.runtime.session import chunk_norm
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.variants.quant import quantize_params
    from whisper_tpu_torch.variants.quantize_int8 import quantize_model_dir

    t_phase = time.perf_counter()
    special = special_tokens("en", "transcribe", None)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    eot = special.eot
    session = make_session("cuda", params, "x5")

    def run(slab: int, **kw):
        """A warm-up, then one run with the counts zeroed before it and
        read after: (e2e s, Timing, rows [chunks, 128] as the mode copied
        them to the host, counts)."""
        rows = []

        def gather(pieces, c, max_new, with_scores=False):
            out = type(session).gather_tokens(pieces, c, max_new,
                                              with_scores)
            rows.append(out)
            return out

        session.gather_tokens = gather
        try:
            transcribe_longform_pipelined(session, audio, "en", "transcribe",
                                          128, slab_chunks=slab, **kw)
            rows.clear()
            _zero_counts(results)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timing = transcribe_longform_pipelined(
                session, audio, "en", "transcribe", 128, slab_chunks=slab,
                **kw)
            e2e = time.perf_counter() - t0
            c = _counts(results)
        finally:
            del session.gather_tokens
        return e2e, timing, np.concatenate(rows), c

    def judged(ref_rows, var_rows, windows, label):
        mel = torch.cat(windows, dim=1)
        n_div, flips, _, margin, bad = _judge(
            session, session, mel,
            [(i * CHUNK_FRAMES, prompt) for i in range(len(windows))],
            ref_rows, var_rows, eot, label)
        if bad:
            raise AssertionError(f"{label}: a divergence that is not a "
                                 f"tie-flip: {bad}")
        same = sum(bool((a == b).all()) for a, b in zip(ref_rows, var_rows))
        return (f"{same} of {len(ref_rows)} rows equal, {n_div} divergences, "
                f"{flips} tie-flips")

    # (a) slab 4 against slab 16
    need = ("fused_attention", "fused_encoder_mlp", "self_attend_step",
            "cross_attend_step")
    runs = {}
    for slab in (4, 16):
        runs[slab] = run(slab)
        e2e, t, rows, c = runs[slab]
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(a) slab {slab}: launches {c}")
        if rows.shape != (12, 128) or not (
                (rows >= 0) & (rows < dims.vocab_size)).all():
            raise AssertionError(f"(a) slab {slab}: rows {rows.shape}")
    slabs, geometry, windows16 = _pipelined_windows(session, audio, 16)
    verdict = judged(runs[16][2], runs[4][2], windows16,
                     "(a) slab 4 against slab 16")
    for slab in (4, 16):
        e2e, t, _, c = runs[slab]
        print(f"[pipelined] (a) whisper-base x5, 301.574 s, slab_chunks "
              f"{slab}, on {card}: e2e {e2e:.4f} s, preprocess "
              f"{t.preprocess_s:.4f} s, model {t.model_only_s:.4f} s, decode "
              f"{t.decode_s:.4f} s; launches {c}", flush=True)
    print(f"[pipelined] (a) slab 4 against slab 16: {verdict}", flush=True)

    # (b) the normalized window on the card against numpy on the host, on
    # slab 16's one raw slab (the whole file)
    raw, (n_valid, _) = slabs[0], geometry[0]
    host = raw.float().cpu().numpy()
    worst = 0.0
    for start in (0, n_valid // 2, n_valid - 100):
        win = np.zeros((dims.n_mels, CHUNK_FRAMES), np.float32)
        avail = max(0, min(start + CHUNK_FRAMES, n_valid) - start)
        win[:, :avail] = host[:, start:start + avail]
        mask = start + np.arange(CHUNK_FRAMES) < n_valid
        win = (np.maximum(win, win[:, mask].max() - np.float32(8.0))
               + np.float32(4.0)) / np.float32(4.0)
        win[:, ~mask] = 0.0
        got = session.chunk_norm_window(raw, start, n_valid).cpu().numpy()
        worst = max(worst, float(np.abs(got - win).max()))
    width = raw.shape[1]
    mel_pad = torch.nn.functional.pad(raw, (0, CHUNK_FRAMES))
    starts = [0, n_valid // 2, width, width]
    bucket = chunk_norm(torch.stack([mel_pad[:, s:s + CHUNK_FRAMES]
                                     for s in starts]), starts, n_valid)
    if worst > 1e-6 or not torch.isfinite(bucket).all() \
            or (bucket[2:] != 0).any():
        raise AssertionError(f"(b) chunk_norm_window: {worst:.3g} from "
                             "numpy, or padding rows not zeros")
    print(f"[pipelined] (b) chunk_norm_window on {card} against numpy on "
          f"the host at frames 0, {n_valid // 2}, {n_valid - 100} of "
          f"{n_valid}: max diff {worst:.3g} (atol 1e-6); a bucket of 4 with "
          "2 padding rows: padding rows all zeros, finite", flush=True)

    # (c) speculative over pipelined: its own int8 weights as draft
    session.set_draft_model(quantize_params(params), dims, share_encoder=True)
    try:
        e2e, t, spec_rows, c = run(4, speculative=True, draft_k=4)
    finally:
        session._draft = None
    if c["cross_attend_multi"] == 0 or c["log_mel"]:
        raise AssertionError(f"(c) speculative pipelined: launches {c}")
    _, _, windows4 = _pipelined_windows(session, audio, 4)
    verdict = judged(runs[4][2], spec_rows, windows4,
                     "(c) speculative against greedy, slab 4")
    print(f"[pipelined] (c) speculative x5 over pipelined, slab 4, own int8 "
          f"weights as draft, on {card}: e2e {e2e:.4f} s, model "
          f"{t.model_only_s:.4f} s; against greedy pipelined: {verdict}; "
          f"launches {c}", flush=True)

    saved_hf = os.environ.get("HF_HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        audio_dir = os.path.join(tmp, "audio")
        one_dir = os.path.join(tmp, "one")
        for d in (audio_dir, one_dir):
            os.makedirs(d)
        for name, secs, sr, ch in CLI_FILES:
            _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        _write_wav(os.path.join(one_dir, CLI_FILES[0][0]), *CLI_FILES[0][1:])
        one_audio = load_audio_16k_mono(
            os.path.join(one_dir, CLI_FILES[0][0]))[0]

        def cli(label, directory, *args):
            out = os.path.join(tmp, "out", label)
            _zero_counts(results)
            t0 = time.perf_counter()
            rc = cli_main(["--audio-dir", directory, "--model-id",
                           "openai/whisper-base", "--max-new-tokens", "128",
                           "--out-csv", f"{out}/inference_per_file.csv",
                           "--out-json", f"{out}/inference_per_file.json",
                           "--out-summary-json",
                           f"{out}/inference_summary.json", *args])
            wall = time.perf_counter() - t0
            c = _counts(results)
            rows = json.load(open(f"{out}/inference_per_file.json"))
            if rc != 0 or len(rows) != len(os.listdir(directory)):
                raise AssertionError(f"{label}: rc {rc}, {len(rows)} rows")
            return rows, c, wall, out

        # (d) the converter and the int8 quantizer
        t0 = time.perf_counter()
        model_dir = os.path.join(tmp, "whisper-base")
        convert.save_params(params, dims, model_dir,
                            {"model_id": "openai/whisper-base"})
        back, dims2 = convert.load_params(model_dir)
        flat, flat_back = convert._flatten(params), convert._flatten(back)
        if dims2 != dims or sorted(flat) != sorted(flat_back) or not all(
                np.array_equal(flat[k], flat_back[k]) for k in flat):
            raise AssertionError("(d) load_params(save_params(x)) != x")
        int8_dir = quantize_model_dir(model_dir)
        qback, _ = convert.load_params(int8_dir)
        qflat, qwant = convert._flatten(qback), convert._flatten(
            quantize_params(params))
        if sorted(qflat) != sorted(qwant) or not all(
                np.array_equal(qflat[k], qwant[k]) for k in qwant):
            raise AssertionError("(d) the int8 dir is not quantize_params")
        t_files = time.perf_counter() - t0
        if "safetensors" in sys.modules or "jax" in sys.modules:
            raise AssertionError("(d) safetensors or jax was imported")
        rows, c5, w5, _ = cli("from-dir-x5", one_dir, "--onnx-dir",
                              model_dir, "--variant", "x5")
        want, _ = transcribe_longform(session, one_audio, "en", "transcribe",
                                      128)
        if rows[0]["text"] != want:
            raise AssertionError("(d) the CLI from the model dir gives other "
                                 "tokens than the in-memory session")
        rows, c4, w4, _ = cli("from-dir-int8", one_dir, "--onnx-dir",
                              int8_dir, "--variant", "int8")
        want, _ = transcribe_longform(make_session("cuda", params, "x4"),
                                      one_audio, "en", "transcribe", 128)
        if rows[0]["text"] != want or c4["cross_attend_step_dequant"] == 0:
            raise AssertionError(f"(d) the CLI from the int8 dir: launches "
                                 f"{c4}, or other tokens than a session "
                                 "that quantizes in memory")
        print(f"[pipelined] (d) converter on {card}'s machine (no jax, no "
              f"safetensors): whisper-base written, read back value for "
              f"value and quantized in {t_files:.1f} s; the CLI from the dir "
              f"at x5 ({w5:.1f} s) and from the int8 dir at int8 "
              f"({w4:.1f} s) on the 4 s file: text equal to the in-memory "
              f"sessions'; launches int8 {c4}", flush=True)

        # (e) the discovery tuner, then the CLI with its JSON
        best = os.path.join(tmp, "best.json")
        t0 = time.perf_counter()
        if discover.main(["--synthetic-s", "60", "--variants", "x4,x5,x7",
                          "--runs", "1", "--out", best]) != 0:
            raise AssertionError("(e) discover failed")
        t_disc = time.perf_counter() - t0
        found = json.load(open(best))
        winner = found["sweep"][0]["variant"]
        _, c, _, _ = cli("discovered", one_dir, "--allow-random-init",
                         "--discovery-best-json", best)
        step = {"x4": "cross_attend_step_dequant", "x5": "cross_attend_step",
                "x7": "self_attend_step_int8"}[winner]
        if c[step] == 0 or c["fused_attention"] == 0:
            raise AssertionError(f"(e) the CLI with the {winner} JSON: "
                                 f"launches {c}")
        print(f"[pipelined] (e) discover, 60 s synthetic, x4/x5/x7, one run "
              f"each, on {card}: {t_disc:.1f} s; sweep "
              + ", ".join(f"{r['variant']} {r['e2e_s']:.4f} s"
                          for r in found["sweep"])
              + f"; the CLI with its JSON ran {winner}: launches {c}",
              flush=True)

        # (f) the CLI in the pipelined mode, then the results tools
        res = os.path.join(tmp, "out")
        rows, c, wall, out = cli("whisper_tpu_torch_x5", audio_dir,
                                 "--allow-random-init", "--variant", "x5",
                                 "--longform-mode", "pipelined",
                                 "--warmup", "1")
        if any(c[n] == 0 for n in need) or c["log_mel"]:
            raise AssertionError(f"(f) CLI pipelined: launches {c}")
        e2e = [r["end_to_end_s"] for r in rows]
        wrows, wc, wwall, _ = cli("pipelined-words", audio_dir,
                                  "--allow-random-init", "--variant", "x5",
                                  "--longform-mode", "pipelined",
                                  "--word-timestamps", "--language", "auto")
        n_words = sum(len(r.get("words") or []) for r in wrows)
        if not all("words" in r for r in wrows) or wc["log_mel"]:
            raise AssertionError(f"(f) CLI pipelined with words: launches "
                                 f"{wc}")
        if summarize.main(["--results-dir", res]) != 0:
            raise AssertionError("(f) results.summarize failed")
        table = list(csv.DictReader(open(os.path.join(
            res, "summary_table.csv"))))
        timed = [r for r in table if r["time_s"]]
        if [r["implementation"] for r in timed] != [
                "whisper-tpu-torch (int8 x int8)"]:
            raise AssertionError(f"(f) summary rows with a time: {timed}")
        if accumulate.main([
                "--results-md", os.path.join(tmp, "RESULTS.md"),
                "--summary-table", os.path.join(res, "summary_table.md"),
                "--summary-csv", os.path.join(res, "summary_table.csv"),
                "--sut-name", "h100", "--core-count",
                str(os.cpu_count() or 1), "--memory-gb", "80",
                "--results-csv", os.path.join(tmp, "RESULTS.csv")]) != 0:
            raise AssertionError("(f) results.accumulate failed")
        hist = list(csv.DictReader(open(os.path.join(tmp, "RESULTS.csv"))))
        if [r["time_s"] for r in hist if r["time_s"]] != [timed[0]["time_s"]]:
            raise AssertionError("(f) RESULTS.csv does not hold the run")
        print(f"[pipelined] (f) CLI --longform-mode pipelined x5 over the "
              f"four files, on {card}: per-file e2e "
              + ", ".join(f"{x:.4f}" for x in e2e)
              + f" s, wall {wall:.1f} s with warm-up; launches {c}; with "
              f"--word-timestamps --language auto: {n_words} words, wall "
              f"{wwall:.1f} s; summary row {timed[0]['implementation']} "
              f"{timed[0]['time_s']} s, RESULTS.md/.csv written", flush=True)
    if saved_hf is None:
        os.environ.pop("HF_HOME", None)
    else:
        os.environ["HF_HOME"] = saved_hf
    print(f"[pipelined] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return runs[4][3]


# ---------------------------------------------------------------------------
# [audio]: the native decoder; [parallel]: the mesh layer on one card
# ---------------------------------------------------------------------------

def check_audio(card: str, results) -> None:
    """``[audio]``: the native decoder built from the checkout (g++ and
    libav's headers on this machine), the 76 s clip written as a FLAC
    (``audio.flac.write_flac``) beside its WAV, both decoded sample for
    sample alike, then both through the CLI at whisper-base x5: equal
    texts.  Without the headers or g++ it prints why and goes on: a host
    library this machine lacks, not the card or a kernel."""
    import numpy as np

    from whisper_tpu_torch.audio.flac import write_flac
    from whisper_tpu_torch.bench.cli import main as cli_main
    from whisper_tpu_torch.headline import synth_audio
    from whisper_tpu_torch.native import audio_native

    t0 = time.perf_counter()
    if not audio_native.available():
        print("[audio] native decoder not built: "
              f"{audio_native.unavailable_reason()}", flush=True)
        return
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        wav = os.path.join(audio_dir, "c_76s.wav")
        flac = os.path.join(audio_dir, "c_76s.flac")
        _write_wav(wav, 76.0, 16000, 1)
        pcm = np.clip(synth_audio(76.0) * 32768.0, -32768, 32767
                      ).astype("<i2")       # _write_wav's samples
        write_flac(flac, pcm, 16000)
        t1 = time.perf_counter()
        from_wav, _ = audio_native.decode_mono(wav)
        t2 = time.perf_counter()
        from_flac, _ = audio_native.decode_mono(flac)
        t3 = time.perf_counter()
        if not np.array_equal(from_wav, from_flac):
            raise AssertionError("[audio] the FLAC decodes to other samples "
                                 "than its WAV")
        out = os.path.join(tmp, "out")
        _zero_counts(results)
        rc = cli_main(["--audio-dir", audio_dir, "--onnx-dir",
                       os.path.join(tmp, "no-model"), "--allow-random-init",
                       "--variant", "x5", "--out-csv", f"{out}/c.csv",
                       "--out-json", f"{out}/j.json", "--out-summary-json",
                       f"{out}/s.json"])
        counts = _counts(results)
        rows = {r["file"]: r for r in json.load(open(f"{out}/j.json"))}
        if rc != 0 or set(rows) != {"c_76s.wav", "c_76s.flac"}:
            raise AssertionError(f"[audio] CLI rc {rc}, rows {sorted(rows)}")
        if rows["c_76s.wav"]["text"] != rows["c_76s.flac"]["text"]:
            raise AssertionError("[audio] the FLAC's text differs from the "
                                 "WAV's")
        print(f"[audio] native decoder (build or load {build_s:.2f} s): the "
              f"76 s clip as WAV and FLAC decoded in {1e3 * (t2 - t1):.1f} / "
              f"{1e3 * (t3 - t2):.1f} ms, sample-equal; CLI whisper-base x5 "
              f"on {card}: per-file e2e WAV "
              f"{rows['c_76s.wav']['end_to_end_s']:.4f} s, FLAC "
              f"{rows['c_76s.flac']['end_to_end_s']:.4f} s, texts equal; "
              f"launches {counts}; phase {time.perf_counter() - t0:.1f} s",
              flush=True)


PARALLEL_CONFIGS = (("dp2 x5", "x5", 2, 1), ("tp2 x5", "x5", 1, 2),
                    ("tp2 x7", "x7", 1, 2))
PROMPT = [50258, 50259, 50359, 50363]   # sot, en, transcribe, notimestamps
EOT = 50257


def _module_counts() -> dict:
    """The launch counts of the main path's kernels (and B8) in this
    process, the graphs' bodies that ran added."""
    from whisper_tpu_torch.ops import (
        attention,
        cross_attention,
        encoder_mlp,
        self_attention,
    )
    from whisper_tpu_torch.ops.common import settle_launches

    settle_launches(wait=True)
    return {"fused_attention": attention.launches,
            "fused_encoder_mlp": encoder_mlp.launches,
            "self_attend_step": self_attention.launches,
            "self_attend_step_int8": self_attention.int8_launches,
            "cross_attend_step": cross_attention.launches}


def _zero_module_counts() -> None:
    from whisper_tpu_torch.ops import (
        attention,
        cross_attention,
        encoder_mlp,
        self_attention,
    )
    from whisper_tpu_torch.ops.common import settle_launches

    settle_launches(wait=True)
    attention.launches = encoder_mlp.launches = 0
    self_attention.launches = self_attention.int8_launches = 0
    cross_attention.launches = 0


def _async_dispatch(session, audio, calls: int = 3) -> tuple:
    """The file's bucket through ``transcribe_from_mel_async``: (host ms
    until it returns, its program and under a mesh the tokens' gather
    queued; ms of the card's span of that work, CUDA events; graph launches
    a call), medians of ``calls`` after one more; then the pools the
    session's graphs keep (bytes)."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket

    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    out = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(True), torch.cuda.Event(True)
        ev0.record()
        t0 = time.perf_counter()
        with _graph_launches() as launches:
            pieces = session.transcribe_from_mel_async(mel, starts, PROMPT,
                                                       128, EOT)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev1.record()
        session.gather_tokens(pieces, len(starts), 128)
        out.append((host_ms, ev0.elapsed_time(ev1), len(launches)))
    return (*(statistics.median(o[i] for o in out[1:]) for i in range(3)),
            sum(session.graphs.pools().values()))


def parallel_rank(rank: int, port: int, ref_path: str, out_path: str) -> int:
    """One of the two ranks of ``[parallel]`` (b): a gloo world of 2 on
    cuda:0 (NCCL refuses two ranks on one card; gloo carries the CUDA
    tensors through the host).  Each configuration of
    ``PARALLEL_CONFIGS``: a warm-up (a graphed rank's at the run's key, so
    the run captures nothing; an eager one short), then one run of the
    301.574 s file with the counts set to 0 just before and read just
    after, its graph launches counted; a graphed rank runs the file once
    more eagerly (``eager_decode``), whose tokens must be its graphed
    run's; every chunk whose chain differs from the one-process bucket-16
    run's is judged by ``divergence_report`` (through the mesh session's
    own field under TP).  Writes its results to ``out_path``."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        make_session,
        run_once,
        synth_audio,
    )
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.parallel import mesh as pm
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket

    pm.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                        timeout_s=300)
    ref = json.load(open(ref_path))
    dims = get_dims("openai/whisper-base")
    params = init_params(dims, seed=0)
    audio = synth_audio(AUDIO_SECONDS)
    nv = golden.num_frames(len(audio))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    out = {}
    for label, variant, dp, tp in PARALLEL_CONFIGS:
        session = make_session("cuda", params, variant, data_parallel=dp,
                               tensor_parallel=tp)
        path = session.decode_path
        graphed = path == "graphed"
        run_once(session, audio, max_new_tokens=128 if graphed else 8)
        _zero_module_counts()
        torch.cuda.synchronize()
        collector = []
        with _graph_launches() as launches:
            t0 = time.perf_counter()
            _, timing = run_once(session, audio, token_collector=collector)
            torch.cuda.synchronize()
            e2e = time.perf_counter() - t0
        counts = _module_counts()
        toks = collector[0]
        eager = {}
        if graphed:
            collector = []
            with _eager_loop(session):
                t0 = time.perf_counter()
                run_once(session, audio, token_collector=collector)
                torch.cuda.synchronize()
                eager = {"e2e_eager": time.perf_counter() - t0,
                         "eager_equal": bool(np.array_equal(collector[0],
                                                            toks))}
            eager["async"] = _async_dispatch(session, audio)
        want = np.asarray(ref[variant], dtype=toks.dtype)
        s_ref = make_session("cuda", params, variant)
        mel = s_ref.compute_mel(golden.reflect_pad(audio), nv,
                                mel_frame_bucket(nv))
        n_div, flips, d_max, margin, drift = _judge(
            s_ref, session if tp > 1 else s_ref, mel,
            [(s, PROMPT) for s in starts], want, toks, EOT, label)
        out[label] = {"e2e": e2e, "model_s": timing.model_only_s,
                      "path": path, "launches": len(launches),
                      "launch_ms": launches, **eager,
                      "counts": counts, "rows_equal": int(sum(
                          (a == b).all() for a, b in zip(toks, want))),
                      "tokens_equal": float((toks == want).mean()),
                      "divergences": n_div, "tie_flips": flips,
                      "max_dlogit_chain": d_max, "margin": margin,
                      "not_tie_flips": [(d.step, d.x0_token, d.var_token,
                                         d.x0_margin) for d in drift],
                      "shape": list(toks.shape)}
        del session, s_ref
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _node_all_reduce(group, trips: int = 128) -> dict:
    """``[parallel]`` (a'): ``dist.all_reduce`` on ``group`` (NCCL) inside
    a while node's body, [16, 512] fp32 (a TP rank's partial O, XO or FC2
    output at bucket 16): the body ``y = x * 0.75 + 0.125``, the
    all-reduce of y, ``x = y``, ``trips += 1``, under the bound ``trips``
    (no done flag ever set).  The body's trial capture is walked first
    (``generate._bad_body_node``), then the graph of one node launched:
    trips and x bitwise an eager loop of the same steps.  Device µs an
    iteration (CUDA events over a launch, best of three) beside the same
    body without the all-reduce, and each body's device operations."""
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch.runtime.generate import _bad_body_node

    dev = torch.device("cuda")
    x0 = torch.randn(16, 512, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    out = {}
    for reduce in (True, False):
        x = x0.clone()
        count = torch.zeros(1, dtype=torch.long, device=dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)

        def body():
            y = x * 0.75 + 0.125
            if reduce:
                dist.all_reduce(y, group=group)
            x.copy_(y)
            count.add_(1)

        want = x0.clone()
        for _ in range(trips):         # eager: the communicator made here
            want = want * 0.75 + 0.125
            if reduce:
                dist.all_reduce(want, group=group)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        trial = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            trial.capture_begin(capture_error_mode="thread_local")
            try:
                body()
                bad = _bad_body_node(side)
            finally:
                trial.capture_end()
        del trial
        if bad is not None:
            raise AssertionError(f"[parallel] (a') the all-reduce left a "
                                 f"node of type {bad} in a capture")
        graph, info = _node_graph(done, count, trips, body)
        times = []
        for _ in range(3):
            x.copy_(x0)
            count.zero_()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / trips)
            if int(count) != trips or not torch.equal(x, want):
                raise AssertionError(
                    f"[parallel] (a') the while node ran {int(count)} "
                    f"trips of {trips}, x bitwise the eager loop's: "
                    f"{torch.equal(x, want)} (all-reduce {reduce})")
        out["with" if reduce else "without"] = (min(times),
                                                info["body_ops"])
    return out


def check_parallel(card: str, results, params, dims, audio, x5,
                   x7_tokens) -> None:
    """``[parallel]``, whisper-base at full width, the 301.574 s file.
    (a) A world of one over NCCL through the mesh code path (dp = tp = 1:
    ``make_mesh`` over the group, ``shard_params``, the data rows, the
    row-parallel branches, whose sums over one rank make no call), graphed
    by the rule: one graph launch a bucket, tokens bitwise the session's
    without a group and the same world's eager run, the same launches;
    e2e of both.  (a') An NCCL all-reduce in a while node's body
    (``_node_all_reduce``), and what the card's torch offers of NCCL's own
    calls on the group's communicator.  (b) Two ranks sharing cuda:0 over
    gloo, spawned with a timeout (``parallel_rank``): DP 2 at x5, each
    rank graphed, one launch a bucket, bitwise its eager run; TP 2 at x5
    and at x7 (4 of 8 heads a rank through B1, B3 or B8, and B4), eager by
    the rule; every divergence from the one-process rows must be a
    tie-flip, each rank's launches as predicted.  e2e beside the
    one-process run's: two processes on one card, gloo copying through the
    host; a record, not a claim."""
    import subprocess

    import numpy as np
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch.headline import make_session
    from whisper_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    n_l, n_e = dims.decoder_layers, dims.encoder_layers
    pm.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl",
                        timeout_s=300)
    try:
        mesh = pm.make_mesh(1, 1)
        session = make_session("cuda", params, "x5", mesh=mesh)
        path = session.decode_path
        if path != "graphed":
            raise AssertionError(f"[parallel] (a) a world of one over NCCL "
                                 f"decodes {path}, not graphed by the rule")
        with _graph_launches() as launches:
            e2e, timing, toks, c = _timed_run(session, audio, results)
        with _eager_loop(session), _graph_launches() as eager_launches:
            e2e_eager, timing_eager, toks_eager, c_eager = _timed_run(
                session, audio, results)
        a_host, a_span, a_launches, a_pools = _async_dispatch(session, audio)
        del session
        # one NCCL collective on the card: the tokens summed over the world
        summed = torch.as_tensor(toks, device="cuda")
        dist.all_reduce(summed)
        if not np.array_equal(summed.cpu().numpy(), toks):
            raise AssertionError("[parallel] (a) an NCCL all-reduce over a "
                                 "world of one changed its tensor")
        node = _node_all_reduce(mesh.group(pm.MODEL_AXIS))
        backend = mesh.group(pm.MODEL_AXIS)._get_backend(
            torch.device("cuda"))
        comm_ptr = hasattr(backend, "_comm_ptr")
        version = torch.cuda.nccl.version()
        nccl_version = (".".join(map(str, version))
                        if isinstance(version, tuple) else str(version))
    finally:
        dist.destroy_process_group()
    # the warm-up's launch and the run's: one bucket of 16 each
    if len(launches) != 2 or eager_launches:
        raise AssertionError(f"[parallel] (a) graph launches {len(launches)}"
                             f" graphed (2: the warm-up's and the run's), "
                             f"{len(eager_launches)} eager")
    if not (np.array_equal(toks, x5[2]) and np.array_equal(toks_eager, toks)
            and c == x5[3] == c_eager):
        raise AssertionError("[parallel] (a) the world of one over NCCL "
                             "differs from the session without a group or "
                             "from its eager run")
    print(f"[parallel] (a) whisper-base x5, 301.574 s, a world of one over "
          f"NCCL through the mesh (dp 1 x tp 1) on {card}: {path} by the "
          f"rule, one graph launch a bucket (host {launches[-1]:.3f} ms); "
          f"tokens bitwise the one-process run's and the eager run's, "
          f"launches equal; e2e {e2e:.4f} s graphed, {e2e_eager:.4f} s "
          f"eager (model {timing.model_only_s:.4f} / "
          f"{timing_eager.model_only_s:.4f} s; one-process median "
          f"{x5[0]:.4f} s); transcribe_from_mel_async returns after "
          f"{a_host:.3f} ms of host time, {a_launches:.0f} launch, of a "
          f"{a_span:.3f} ms span on the card; pools {a_pools / 2**30:.3f} "
          "GiB", flush=True)
    (with_us, with_ops), (without_us, without_ops) = (node["with"],
                                                      node["without"])
    print(f"[parallel] (a') an NCCL all-reduce of [16, 512] fp32 on the "
          f"world's group inside a while node's body on {card}: 128 trips "
          f"and values bitwise the eager loop; no node a body may not hold "
          f"in its trial capture; {with_us:.3f} µs an iteration, "
          f"{with_ops} device operations a body, against {without_us:.3f} "
          f"µs and {without_ops} without the all-reduce (NCCL "
          f"{nccl_version} in torch {torch.__version__}; the group's "
          f"backend has _comm_ptr: {comm_ptr})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.json")
        with open(ref_path, "w") as f:
            json.dump({"x5": x5[2].tolist(), "x7": x7_tokens.tolist()}, f)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), str(port), ref_path, os.path.join(tmp, f"rank{r}.json")])
            for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("[parallel] (b) a rank exited with "
                                 f"{[p.returncode for p in procs]}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(2)]
    steps = 127 * n_l
    for label, variant, dp, tp in PARALLEL_CONFIGS:
        r0, r1 = ranks[0][label], ranks[1][label]
        for r, res in enumerate((r0, r1)):
            if tp == 1 and (res["path"] != "graphed" or res["launches"] != 1
                            or not res["eager_equal"]):
                raise AssertionError(
                    f"[parallel] (b) {label} rank {r}: {res['path']}, "
                    f"{res['launches']} graph launches (1: one bucket), "
                    f"eager tokens equal {res.get('eager_equal')}")
            if tp > 1 and (not res["path"].startswith("eager")
                           or res["launches"]):
                raise AssertionError(
                    f"[parallel] (b) {label} rank {r}: {res['path']}, "
                    f"{res['launches']} graph launches, not eager by the "
                    "rule")
        self_b = "self_attend_step_int8" if variant == "x7" \
            else "self_attend_step"
        want = {"fused_attention": n_e, "fused_encoder_mlp": n_e,
                "cross_attend_step": steps, self_b: steps}
        for r, res in enumerate((r0, r1)):
            got = {k: v for k, v in res["counts"].items() if v}
            if got != want:
                raise AssertionError(f"[parallel] (b) {label} rank {r}: "
                                     f"launches {got}, expected {want}")
            if res["not_tie_flips"]:
                raise AssertionError(f"[parallel] (b) {label} rank {r}: "
                                     "divergences that are not tie-flips: "
                                     f"{res['not_tie_flips']}")
        if r0["tokens_equal"] != r1["tokens_equal"]:
            raise AssertionError(f"[parallel] (b) {label}: the ranks hold "
                                 "different tokens")
        one = x5[0]
        print(f"[parallel] (b) whisper-base {label}, 301.574 s, two gloo "
              f"ranks sharing cuda:0 on {card}: e2e rank 0 {r0['e2e']:.4f} "
              f"s, rank 1 {r1['e2e']:.4f} s (one process, x5 median: "
              f"{one:.4f} s); model {r0['model_s']:.4f} s; rows equal to the "
              f"one-process bucket-16 rows {r0['rows_equal']} of "
              f"{r0['shape'][0]}, tokens {r0['tokens_equal']:.4f}; "
              f"{r0['divergences']} divergences, {r0['tie_flips']} tie-flips "
              f"(largest reference margin {r0['margin']:.4f}, "
              f"max_dlogit_chain {r0['max_dlogit_chain']:.4f}); launches a "
              f"rank {r0['counts']} / {r1['counts']}", flush=True)
        if tp == 1:
            (h0, s0, _, p0), (h1, s1, _, p1) = r0["async"], r1["async"]
            print(f"[parallel] (b) {label}: each rank graphed, one launch "
                  f"a bucket (host {r0['launch_ms'][0]:.3f} / "
                  f"{r1['launch_ms'][0]:.3f} ms), tokens bitwise its eager "
                  f"run; e2e eager rank 0 {r0['e2e_eager']:.4f} s, rank 1 "
                  f"{r1['e2e_eager']:.4f} s; transcribe_from_mel_async "
                  f"returns after {h0:.3f} / {h1:.3f} ms of host time (the "
                  f"gloo gather waits for the card), spans {s0:.3f} / "
                  f"{s1:.3f} ms; pools a rank {p0 / 2**30:.3f} / "
                  f"{p1 / 2**30:.3f} GiB", flush=True)
        else:
            print(f"[parallel] (b) {label}: {r0['path']}: the rule "
                  "(generate.graphed) chose the eager loop before any "
                  "capture, no graph launched", flush=True)
    print(f"[parallel] phase {time.perf_counter() - t0:.1f} s", flush=True)


# [medium]: the medium family on the card at full width
SMALL = "openai/whisper-small"
MEDIUM = "openai/whisper-medium"
MEDIUM_EN = "openai/whisper-medium.en"
DISTIL_MEDIUM_EN = "distil-whisper/distil-medium.en"
# [medium] (c): the card within these bf16 steps of the CPU's encoder
# states after the model's layers: base's 8 at 6 layers, scaled by the
# port's bf16 encoder's distance from fp32 on the CPU at the model's widths
# (``scripts/torch_encoder_depth.py``): whisper-small 7.04 bf16 steps at 6
# layers and 7.54 at 12 (8 x 7.54 / 7.04 = 8.6), whisper-medium 6.28 at 6
# and 11.90 at 24 (8 x 11.90 / 6.28 = 15.2).  The logits keep base's 5e-2.
MEDIUM_ENC_STEPS = {SMALL: 9.0, MEDIUM: 16.0}
# [medium] (d): ids suppressed at every step, the English-only
# vocabulary's last id (51,863) among them, and at the first step
MEDIUM_EN_SUPPRESS = [1, 2, 220, 50357, 51863]
MEDIUM_EN_BEGIN_SUPPRESS = [220, EOT]


@contextlib.contextmanager
def _drawn_weights(*drawn):
    """Within the block the port's ``convert.init_params`` hands back each
    of ``drawn`` ((dims, seed, tree): the tree it would draw, drawn before)
    in place of drawing it again: a CLI run's ``--allow-random-init``
    weights, the very arrays, without the ~20 s a billion normals take."""
    from whisper_tpu_torch.models import convert

    draw = convert.init_params

    def init_params(dims, seed=0):
        for d, s, tree in drawn:
            if d == dims and s == seed:
                return tree
        return draw(dims, seed)

    convert.init_params = init_params
    try:
        yield
    finally:
        convert.init_params = draw


def check_medium_kernels(card: str, results) -> None:
    """The kernels of the medium family's path at its shapes: whisper-small
    (12 heads, d = 768, f = 3,072, 12 decoder layers) and whisper-medium (16
    heads, d = 1,024, f = 4,096, 24 decoder layers), bucket 16, 1500
    positions: B1 (beside ``scaled_dot_product_attention``), B2c (the
    "chunked" JAX rule's MLP at both widths: the port's one B2 kernel,
    beside the bf16 composition of five PyTorch calls), B9a at d = 768 and
    B9a' at d = 1,024 (beside their composition of two), B3 and B4 at both
    (B4 bitwise; B3's caches bitwise, its output within 2 bf16 steps: the
    plain version's scores are a cuBLAS product in an order of the
    library's choosing), B6 at whisper-small (x4, the CLI's rung)
    and B7-i8 at whisper-medium.en's verify pass (16 rows, 16 heads, five
    queries, each bitwise B4's); each against its plain version within its
    tolerance, timed beside it and its bound.  The figures go into the rows
    of ``results`` under ``at_whisper_small`` and ``at_whisper_medium``
    (B2c's row is ``fused_encoder_mlp_d1024``, B9a's ``fused_ln_qkv`` and
    the row of B9a' ``fused_ln_qkv_d1024``)."""
    import torch

    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
    from whisper_tpu_torch.ops import encoder_block, self_attention

    g, randn, qweight = _card_inputs(7)
    b, t, dh, s_max, pos, n_q = 16, 1500, 64, 132, 70, 5
    n = b * t
    for model_id, at, b9a in ((SMALL, "at_whisper_small", "fused_ln_qkv"),
                              (MEDIUM, "at_whisper_medium",
                               "fused_ln_qkv_d1024")):
        dims = get_dims(model_id)
        d, f, h, n_l = (dims.d_model, dims.d_ffn, dims.encoder_heads,
                        dims.decoder_layers)
        q, k, v = randn(b, h, t, dh, scale=dh ** -0.5), randn(b, h, t, dh), \
            randn(b, h, t, dh)
        mlp = (randn(b, t, d), 1.0 + randn(d, scale=0.1), randn(d, scale=0.1),
               qweight(d, f), randn(f, scale=0.1), qweight(f, d),
               randn(d, scale=0.1))
        qkv = mlp[:3] + (qweight(d, 3 * d), randn(3 * d, scale=0.1))
        qs, kn, vn = randn(b, h, dh, scale=dh ** -0.5), randn(b, h, dh), \
            randn(b, h, dh)
        kc, vc = randn(n_l, b, h, s_max, dh), randn(n_l, b, h, s_max, dh)
        kc2, vc2 = kc.clone(), vc.clone()
        qx = randn(b, h, dh, scale=dh ** -0.5)
        k8, v8 = (torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(n_l, b, h, generator=g, device="cuda") * 0.02
                  + 1e-3 for _ in range(2))
        cross = (k8, v8, ks, vs)
        cross_bytes = b * h * (2 * t * dh + 2 * dh * 2 + 8)
        cases = [
            ("fused_attention", at,
             lambda: attention.fused_attention(q, k, v),
             lambda: attention.fused_attention_plain(q, k, v), 2.0,
             (4 * b * h * t * dh * 2, 4 * b * h * t * t * dh, "bf16"),
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v, scale=1.0), None),
            ("fused_encoder_mlp_d1024", at,
             lambda: encoder_mlp.fused_encoder_mlp(*mlp),
             lambda: encoder_mlp.fused_encoder_mlp_plain(*mlp), 2.0,
             ((2 * n * d + 2 * d * f + 3 * d + f) * 2, 4 * n * d * f, "bf16"),
             lambda: _encoder_mlp_composition(*mlp), None),
            (b9a, at, lambda: encoder_block.fused_ln_qkv(*qkv),
             lambda: encoder_block.fused_ln_qkv_plain(*qkv), 2.0,
             ((n * d + n * 3 * d + d * 3 * d + 5 * d) * 2,
              2 * n * d * 3 * d, "bf16"),
             lambda: _qkv_composition(*qkv), None),
            ("self_attend_step", at,
             lambda: self_attention.self_attend_step(qs, kn, vn, kc, vc, 3,
                                                     pos),
             lambda: self_attention.self_attend_step_plain(
                 qs, kn, vn, kc2, vc2, 3, pos), 2.0,
             (b * h * dh * 2 * (2 * (pos + 1) + 6),
              4 * b * h * (pos + 1) * dh, "fp32"), None,
             lambda got, want: torch.equal(kc, kc2) and torch.equal(vc, vc2)),
            ("cross_attend_step", at,
             lambda: cross_attention.cross_attend_step(qx, *cross, 2,
                                                       s_valid=t),
             lambda: cross_attention.cross_attend_step_plain(qx, *cross, 2,
                                                             s_valid=t), 2.0,
             (cross_bytes, 4 * b * h * t * dh, "int8"), None, torch.equal),
        ]
        if model_id == SMALL:
            cases.append((
                "cross_attend_step_dequant", at,
                lambda: cross_attention.cross_attend_step_dequant(
                    qx, *cross, 2, s_valid=t),
                lambda: cross_attention.cross_attend_step_dequant_plain(
                    qx, *cross, 2, s_valid=t), 2.0,
                (cross_bytes, 4 * b * h * t * dh, "fp32"), None, None))
        else:
            qm = randn(b, n_q, h, dh, scale=dh ** -0.5)

            def queries_are_b4s(got, want):
                return torch.equal(got, want) and all(
                    torch.equal(got[:, i], cross_attention.cross_attend_step(
                        qm[:, i].contiguous(), *cross, 2, s_valid=t))
                    for i in range(n_q))

            cases.append((
                "cross_attend_multi", at,
                lambda: cross_attention.cross_attend_multi(
                    qm, *cross, 2, s_valid=t, int8_mxu=True),
                lambda: cross_attention.cross_attend_multi_plain(
                    qm, *cross, 2, s_valid=t, int8_mxu=True), 2.0,
                (b * h * (2 * t * dh + 8) + 2 * b * n_q * h * dh * 2,
                 4 * b * n_q * h * t * dh, "int8"), None, queries_are_b4s))
        name = model_id.split("/")[-1]
        _hold_rows("[medium]", cases, {at: f"{name}'s shape ({b} rows, {h} "
                                           f"heads, d = {d}, {n_l} decoder "
                                           f"layers)"}, results, card)
        del q, k, v, mlp, qkv, kc, vc, kc2, vc2, k8, v8, cross, cases
        gc.collect()
        torch.cuda.empty_cache()


def _note_in_situ(traced, results, at: str, b5: bool = False) -> None:
    """The in-situ µs a call of B1, B2c (its three kernels), B3, B4 and,
    with ``b5``, B5 (the span of its two) from a trace summary
    (``_traced``) into the rows of ``results`` under ``at``: None where
    the trace holds no such kernel."""
    by_name = {r["name"]: r for r in results}
    kern = traced["kernels"]
    b2 = ("B2 (LayerNorm)", "B2 (FC1 product)", "B2 (FC2 product)")
    ms = {"fused_attention": kern.get("B1", {}).get("mean_ms"),
          "fused_encoder_mlp_d1024":
              sum(kern[k]["mean_ms"] for k in b2)
              if all(k in kern for k in b2) else None,
          "self_attend_step": kern.get("B3", {}).get("mean_ms"),
          "cross_attend_step": kern.get("B4", {}).get("mean_ms")}
    if b5:
        call = traced["calls"].get("B5")
        ms["log_mel"] = call["mean_ms"] if call else None
    for name, v in ms.items():
        by_name[name][at]["device_us"] = None if v is None else v * 1e3


def _file_runs(session, audio, results, label: str) -> tuple:
    """The 301.574 s file (``audio``: 12 chunks in a bucket of 16) through
    ``session`` at x5: a warm-up (the capture) and three timed runs, tokens
    equal and in the vocabulary, one graph launch a bucket, launches by the
    capture's tally (``_bucket_launches``), an eager run (``eager_decode``)
    bitwise the graphed tokens with equal launches, finite encoder states
    and logits.  Returns (e2e median of 3, its Timing, tokens, launches,
    steps run, capture seconds, eager seconds, the key's memory)."""
    import numpy as np
    import torch

    from whisper_tpu_torch.headline import run_once

    dims = session.dims
    e2e, timing, toks, c = _timed_run(session, audio, results, runs=3)
    steps = _bucket_launches(c, _condition_count(), dims, f"{label} graphed")
    (key, capture_s), = session.graphs.captures().items()
    if toks.shape != (12, 128) or not ((toks >= 0)
                                       & (toks < dims.vocab_size)).all():
        raise AssertionError(f"{label}: tokens {toks.shape}")
    with _graph_launches() as launches:
        run_once(session, audio)
    if len(launches) != 1:
        raise AssertionError(f"{label}: {len(launches)} graph launches for "
                             "the file's one bucket")
    with _eager_loop(session):
        _zero_counts(results)
        col = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_once(session, audio, token_collector=col)
        eager_s = time.perf_counter() - t1
        eager_c = _counts(results)
    if not np.array_equal(col[0], toks) or eager_c != c:
        raise AssertionError(f"{label}: the eager run's tokens differ or "
                             f"its launches {eager_c} are not the graphed "
                             f"run's {c}")
    check_main_path_finite(session, audio, dims)
    return (e2e, timing, toks, c, steps, capture_s, eager_s,
            _key_memory(session, key))


def _medium_file(card: str, results, params, model_id: str, audio,
                 part: str) -> dict:
    """``[medium]`` (a) or (b) (``part``): ``model_id`` (``params``) at x5
    on the 301.574 s file, 12 chunks in a bucket of 16.  A warm-up (the
    capture) and three timed runs, tokens equal and in the vocabulary, one
    graph launch a bucket, launches by the capture's tally (B1 = B2 = the
    encoder's layers a program launch, B3 = B4 = the decoder's a step run,
    the tail once a step, C once, no B5), an eager run bitwise the graphed
    tokens with equal launches, finite encoder states and logits; the key's
    state and pools beside ``decode_footprint``'s caches and
    ``program_pool_bytes``, the peak above the part's start, the kernels'
    in-situ µs from a traced eager run of 16 tokens; then (c), the card
    against the port on the CPU on one 30 s chunk, within
    ``MEDIUM_ENC_STEPS`` bf16 steps (encoder) and 5e-2 (logits).  Then the
    same file with ``fused_encoder_block``: the JAX rule's "chunked"
    composition at these widths, B9a = B1 = B2 = the encoder's layers and
    no B9b, B9a's in-situ µs from a traced encoder call; every chunk whose
    tokens differ from the unfused run's judged by ``divergence_report``
    (``_judge``): a first divergence that is not a tie-flip fails.
    Returns the fused run's launches."""
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import AUDIO_SECONDS, make_session, run_once
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops import encoder_block
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket

    dims = get_dims(model_id)
    name = model_id.split("/")[-1]
    label = f"[medium] ({part}) {name} x5"
    at = "at_" + name.replace("-", "_")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    session = make_session("cuda", params, "x5", model_id)
    weights = torch.cuda.memory_allocated() - base
    e2e, timing, toks, c, steps, capture_s, eager_s, memory = _file_runs(
        session, audio, results, label)
    peak = torch.cuda.max_memory_allocated() - base
    with _eager_loop(session):
        traced = _traced(lambda: run_once(session, audio, max_new_tokens=16))
    _note_in_situ(traced, results, at)
    print(f"{label}, {AUDIO_SECONDS} s, 12 chunks in a bucket of 16, on "
          f"{card}: e2e {e2e:.4f} s (median of 3), {AUDIO_SECONDS / e2e:.2f}x"
          f" real time, preprocess {timing.preprocess_s:.4f} s, model "
          f"{timing.model_only_s:.4f} s; eager {eager_s:.4f} s, tokens "
          f"bitwise the graphed run's, launches equal; one graph launch a "
          f"bucket; launches {c} ({steps} steps run; B1, B2 "
          f"{dims.encoder_layers} a program launch, B3, B4 "
          f"{dims.decoder_layers} a step, no B5); capture {capture_s:.2f} s; "
          f"the key: {_gate_line(dims, memory)}; weights {_gib(weights)}, "
          f"peak {_gib(peak)} above the part's start; in situ, µs "
          f"(launches), an eager run of 16 tokens: {_in_situ(traced)}",
          flush=True)

    # (c) the card against the port on the CPU, one 30 s chunk
    check_against_cpu(params, dims, model_id, seconds=30.0, steps=4,
                      enc_steps_tol=MEDIUM_ENC_STEPS[model_id],
                      card_session=session)

    # the fused encoder block: the "chunked" composition at d >= 768
    fused = make_session("cuda", params, "x5", model_id,
                         fused_encoder_block=True)
    mode = encoder_block.fused_block_mode(dims.d_model, dims.d_ffn,
                                          torch.bfloat16)
    f_e2e, _, f_toks, fc = _timed_run(fused, audio, results)
    n_l = dims.encoder_layers
    f_steps = fc["loop_tail"]
    if not (mode == "chunked" and fc["fused_ln_qkv"] == fc["fused_attention"]
            == fc["fused_encoder_mlp"] == n_l and fc["fused_out_mlp"] == 0
            and fc["self_attend_step"] == fc["cross_attend_step"]
            == dims.decoder_layers * f_steps and fc["log_mel"] == 0):
        raise AssertionError(f"{label} with the fused block ({mode}): "
                             f"launches {fc}; want B9a = B1 = B2 = {n_l}, "
                             "no B9b")
    chunks = _bucket_chunks(fused, audio)
    b9a = _traced(lambda: fused.encoder(chunks))["calls"].get("B9a")
    by_name = {r["name"]: r for r in results}
    by_name["fused_ln_qkv" if dims.d_model < 1024
            else "fused_ln_qkv_d1024"][at]["device_us"] = (
        None if b9a is None else b9a["mean_ms"] * 1e3)
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    verdict = _judge(session, fused, mel, [(s, PROMPT) for s in starts],
                     toks, f_toks, EOT, f"{name} fused block")
    print(f"{label}+fused_encoder_block (the JAX rule's \"{mode}\" "
          f"composition: B9a, B1, a plain O-projection, B2) on {card}: e2e "
          f"{f_e2e:.4f} s; launches {fc}; B9a in situ "
          + ("not recorded" if b9a is None
             else f"{b9a['mean_ms'] * 1e3:.2f} µs a call ({b9a['calls']})")
          + f"; against the unfused run's tokens: "
          f"{float((f_toks == toks).mean()):.4f} of {toks.size} equal, "
          + _judge_line(verdict), flush=True)
    if verdict[4]:
        raise AssertionError(f"{label}: fused-block divergences that are "
                             f"not tie-flips: {verdict[4]}")
    del session, fused
    return fc


def _medium_en_speculative(card: str, results, params, draft, audio) -> int:
    """``[medium]`` (d): whisper-medium.en (``params``, x5) on the 301.574 s
    file with ids suppressed across its 51,864-id vocabulary
    (``MEDIUM_EN_SUPPRESS``) and the multilingual fallback's prompt, as
    the JAX package takes it without a tokenizer.json: greedy, graphed (one
    graph launch, launches by the capture's tally); then speculative,
    draft_k 4, on the shared encoder with a random distil-medium.en
    (``draft``: 2 decoder layers) and with whisper-medium.en's own int8
    weights as drafts, graphed after the capture (``[large]`` (e) holds a
    speculative program against its eager loop); rounds counted
    (``speculative_stats``) equal rounds run (B7 launches over 24 layers),
    B7 = 24 x rounds, B4 = the draft's layers x 4 x rounds, B1 = B2 = 24
    (one encoder), no B3, one graph launch; the two drafts' tokens bitwise
    equal, each chunk that differs from the greedy run's judged by
    ``divergence_report``; the key's state and pools beside
    ``speculative_footprint`` and ``program_pool_bytes``.  Then, on the
    bucket's encoder states, greedy with the timestamp grammar (timestamps
    from 50,364 to 51,863) and sampled at T = 0.5 with scores (the pick
    kernel over 51,864 ids), each graphed twice and eagerly once: tokens
    (and scores) bitwise, C once a graphed call, every row within the
    grammar.  No token is a suppressed id or past the vocabulary.  Returns
    the B7 launches of the distil draft's run."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import AUDIO_SECONDS, make_session
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.utils import hbm
    from whisper_tpu_torch.variants.quant import quantize_params

    dims, d_dims, k = get_dims(MEDIUM_EN), get_dims(DISTIL_MEDIUM_EN), 4
    n_l, vocab = dims.decoder_layers, dims.vocab_size
    label = "[medium] (d) whisper-medium.en x5"
    session = make_session("cuda", params, "x5", MEDIUM_EN)
    gen = GenerationCfg(MEDIUM_EN_SUPPRESS, MEDIUM_EN_BEGIN_SUPPRESS)

    def in_vocab(toks, what):
        if ((toks < 0) | (toks >= vocab)).any() \
                or np.isin(toks, MEDIUM_EN_SUPPRESS).any() \
                or np.isin(toks[:, 0], MEDIUM_EN_BEGIN_SUPPRESS).any():
            raise AssertionError(f"{label} {what}: a token past the "
                                 f"{vocab}-id vocabulary or suppressed")

    def run(speculative):
        col = []
        _zero_counts(results)
        with _graph_launches() as launches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            transcribe_longform(session, audio, "en", "transcribe", 128,
                                gen_cfg=gen, token_collector=col,
                                speculative=speculative, draft_k=k)
            e2e = time.perf_counter() - t1
        stats = session.speculative_stats if speculative else []
        rounds = int(sum(r for r, _ in stats))
        committed = float(np.concatenate([c_.cpu().numpy() for _, c_ in
                                          stats]).mean()) if stats else 0.0
        return (e2e, col[0], _counts(results), len(launches), rounds,
                committed, _condition_count())

    run(False)                                     # captures the bucket's key
    g_s, greedy, g_c, g_launch, _, _, g_cond = run(False)
    g_steps = _bucket_launches(g_c, g_cond, dims, f"{label} greedy")
    in_vocab(greedy, "greedy")
    if g_launch != 1 or greedy.shape != (12, 128):
        raise AssertionError(f"{label} greedy: {g_launch} graph launches, "
                             f"tokens {greedy.shape}")
    print(f"{label} greedy, the 301.574 s file, {vocab} ids, suppressed "
          f"{MEDIUM_EN_SUPPRESS} (first step also "
          f"{MEDIUM_EN_BEGIN_SUPPRESS}), on {card}: e2e {g_s:.4f} s "
          f"({AUDIO_SECONDS / g_s:.2f}x real time), one graph launch, "
          f"launches {g_c} ({g_steps} steps run)", flush=True)

    arms = (("a random distil-medium.en", draft, d_dims),
            ("whisper-medium.en's own int8 weights",
             quantize_params({"decoder": params["decoder"]}), dims))
    tokens, b7 = {}, []
    for arm, d_params, dd in arms:
        session.set_draft_model(d_params, dd, share_encoder=True)
        run(True)                                  # captures
        (key, capture_s), = [(kk, s_) for kk, s_ in
                             session.graphs.captures().items()
                             if kk.kind == "speculative"]
        e2e, toks, c, launch, rounds, committed, _ = run(True)
        ran = c["cross_attend_multi"] // n_l
        want = {"fused_attention": dims.encoder_layers,
                "fused_encoder_mlp": dims.encoder_layers,
                "cross_attend_multi": n_l * rounds,
                "cross_attend_step": dd.decoder_layers * k * rounds,
                "self_attend_step": 0, "loop_tail": 0, "log_mel": 0}
        if launch != 1 or rounds != ran \
                or any(c[n_] != v for n_, v in want.items()):
            raise AssertionError(f"{label} with {arm} as draft: {launch} "
                                 f"graph launches, {rounds} rounds counted, "
                                 f"{ran} run, launches {c}; want {want}")
        in_vocab(toks, f"with {arm} as draft")
        tokens[arm] = toks
        b7.append(c["cross_attend_multi"])
        state, inputs, pools = _key_memory(session, key)
        fp = session.speculative_footprint(dd, True)
        caches = fp["kv_cache"] + fp["draft_kv_cache"]
        pool_est = hbm.program_pool_bytes(dims, 16, 4, act_bytes=2)
        print(f"{label} with {arm} as draft on the shared encoder, draft_k "
              f"{k}, on {card}: e2e graphed {e2e:.4f} s "
              f"({AUDIO_SECONDS / e2e:.2f}x real time); one graph launch; "
              f"{rounds} rounds counted and run, {committed / rounds:.3f} "
              f"tokens committed a round and row; launches {c}; capture "
              f"{capture_s:.2f} s; the key: state {_gib(state)} against the "
              f"footprint's caches {_gib(caches)} ({state / caches:.3f}x), "
              f"inputs {_gib(inputs)}, pools {_gib(pools)} against "
              f"program_pool_bytes {_gib(pool_est)} ({pools / pool_est:.3f}x)"
              f"; speculative_footprint total {_gib(fp['total'])}",
              flush=True)
    first, own = tokens.values()
    if not np.array_equal(first, own):
        raise AssertionError(f"{label}: the tokens depend on the draft")
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    verdict = _judge(session, session, mel, [(s, PROMPT) for s in starts],
                     greedy, first, EOT, "speculative medium.en")
    print(f"{label}: the two drafts' tokens bitwise equal; against the "
          f"greedy tokens: {float((first == greedy).mean()):.4f} of "
          f"{first.size} equal, " + _judge_line(verdict), flush=True)
    if verdict[4]:
        raise AssertionError(f"{label}: divergences from greedy that are not "
                             f"tie-flips: {verdict[4]}")

    # the grammar and the sampled pick over 51,864 ids
    enc, _ = _bucket_encoder_states(session, audio)
    masks = session._get_masks(gen.suppress_tokens, gen.begin_suppress_tokens)
    ts_cfg = TimestampCfg(PROMPT[3] + 1, EOT, PROMPT[3])
    for what, kw, prompt in (
            ("the timestamp grammar", {"ts_cfg": ts_cfg}, PROMPT[:3]),
            ("T = 0.5, seed 3, with scores",
             {"temperature": 0.5, "with_scores": True}, PROMPT)):
        p_t = torch.tensor(prompt, device="cuda")

        def decode(eager=False):
            extra = {}
            if "temperature" in kw:
                extra["generator"] = torch.Generator(
                    device="cuda").manual_seed(3)
            _zero_counts(results)
            with _graph_launches() as launches, (
                    _eager_loop(session) if eager
                    else contextlib.nullcontext()):
                out = session._greedy(enc, p_t, *masks, 128, EOT, **kw,
                                      **extra)
            out = tuple(t_.cpu() for t_ in out) if isinstance(out, tuple) \
                else (out.cpu(),)
            return out, _counts(results), len(launches), _condition_count()

        want = decode(eager=True)
        got = [decode(), decode()]        # the capture's call, a later one
        if not all(all(torch.equal(a, b_) for a, b_ in zip(g_[0], want[0]))
                   and g_[1] == want[1] and g_[2] == 1 and g_[3] == 1
                   for g_ in got) or want[3] != 0:
            raise AssertionError(f"{label}, {what}: the graphed calls differ "
                                 "from the eager loop (tokens, scores, "
                                 "launches), or not one graph launch and "
                                 "one C a call")
        if (want[1]["gumbel_pick"] > 0) != ("temperature" in kw):
            raise AssertionError(f"{label}, {what}: the pick kernel launched "
                                 f"{want[1]['gumbel_pick']} times")
        toks = want[0][0].numpy()
        in_vocab(toks, what)
        extra_line = ""
        if "ts_cfg" in kw:
            errs = [(r, e) for r, row in enumerate(toks)
                    for e in _grammar_errors(row, ts_cfg)]
            if errs:
                raise AssertionError(f"{label}: rows break the timestamp "
                                     f"grammar: {errs[:8]}")
            stamps = toks[toks >= ts_cfg.timestamp_begin]
            extra_line = (f"; every row within the grammar, {stamps.size} "
                          f"timestamps ({int(stamps.min())} to "
                          f"{int(stamps.max())})" if stamps.size else
                          "; every row within the grammar")
        print(f"{label}, the bucket of 16 at {what}, 128 tokens, {vocab} "
              f"ids, on {card}: two graphed calls bitwise the eager loop "
              f"(tokens{', scores' if 'temperature' in kw else ''}), one "
              f"graph launch and C once a call, launches equal "
              f"{ {n_: v for n_, v in want[1].items() if v} }{extra_line}",
              flush=True)
    del session
    return b7[0]


def check_medium(card: str, results, drawn: dict) -> dict:
    """``[medium]``: the medium family's main path on the card at full
    width (see the module's docstring, 8d); ``drawn``:
    ``_draw_family_weights``'s futures, whose trees of the family this
    phase takes and lets go.  Returns the launches of the whisper-medium
    fused-block run and of the CLI at whisper-medium x5."""
    import torch

    from whisper_tpu_torch.headline import AUDIO_SECONDS, synth_audio
    from whisper_tpu_torch.models.registry import get_dims

    t_phase = time.perf_counter()
    secs = {}
    check_medium_kernels(card, results)
    secs["kernels"] = time.perf_counter() - t_phase
    audio = synth_audio(AUDIO_SECONDS)
    out = {}
    for part, model_id in (("a", SMALL), ("b", MEDIUM)):
        t0 = time.perf_counter()
        params = drawn[model_id].result()
        secs[f"{model_id} weights, waited for"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[model_id] = _medium_file(card, results, params, model_id, audio,
                                     part)
        secs[f"({part}), (c)"] = time.perf_counter() - t0
    by_name = {r["name"]: r for r in results}
    for row, model_id in (("fused_ln_qkv", SMALL),
                          ("fused_ln_qkv_d1024", MEDIUM)):
        name = model_id.split("/")[-1]
        by_name[row]["at_" + name.replace("-", "_")]["launches"] = \
            out[model_id]["fused_ln_qkv"]

    # (d) whisper-medium.en with a distil-medium.en draft
    t0 = time.perf_counter()
    b7 = _medium_en_speculative(card, results, drawn.pop(MEDIUM_EN).result(),
                                drawn.pop(DISTIL_MEDIUM_EN).result(), audio)
    by_name["cross_attend_multi"]["at_whisper_medium"]["launches"] = b7
    secs["(d)"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (e) the CLI at whisper-small --variant int8 over the 76 s WAV (B5, B6
    # at 12 heads), and at whisper-medium x5 over the 4 s WAV, each with the
    # weights drawn above
    t0 = time.perf_counter()
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        for label, model_id, variant, file, n_new in (
                ("whisper-small-int8", SMALL, "int8", CLI_FILES[2], 128),
                ("whisper-medium-x5", MEDIUM, "x5", CLI_FILES[0], 16)):
            audio_dir = os.path.join(tmp, label + "-audio")
            os.makedirs(audio_dir)
            _write_wav(os.path.join(audio_dir, file[0]), *file[1:])
            with _drawn_weights((get_dims(model_id), 0,
                                 drawn.pop(model_id).result())):
                cli[label] = run_cli(
                    label, card, results, audio_dir, tmp,
                    ["--model-id", model_id, "--max-new-tokens", str(n_new),
                     "--variant", variant], files=(file,))
    small, medium = cli["whisper-small-int8"], cli["whisper-medium-x5"]
    if not (small["log_mel"] > 0 and small["cross_attend_step_dequant"] > 0
            and small["cross_attend_step"] == 0
            and small["self_attend_step"] > 0
            and small["fused_attention"] > 0
            and small["fused_attention"] % 12 == 0
            and small["fused_encoder_mlp"] == small["fused_attention"]):
        raise AssertionError(f"[medium] (e) the CLI at whisper-small int8: "
                             f"launches {small}")
    if not (medium["cross_attend_step"] > 0
            and medium["cross_attend_step_dequant"] == 0
            and medium["self_attend_step"] > 0
            and medium["fused_attention"] > 0
            and medium["fused_encoder_mlp"] > 0):
        raise AssertionError(f"[medium] the CLI at whisper-medium x5: "
                             f"launches {medium}")
    secs["(e)"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    print("[medium] seconds: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items()),
          flush=True)
    return {"fused block": out[MEDIUM], "cli medium x5": medium}


# [large]: the large family on the card at full width
LARGE_TURBO = "openai/whisper-large-v3-turbo"
LARGE_V3 = "openai/whisper-large-v3"
LARGE_DISTIL = "distil-whisper/distil-large-v3"
# large-v3's special ids: its tokenizer holds one language more than the
# multilingual models', so its task ids, <|startofprev|> and
# <|notimestamps|> sit one higher than those of the fallback without a
# tokenizer.json (``tokenizer.specials``), and its timestamps start at
# 50,365
LARGE_V3_SPECIALS = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
                     "<|en|>": 50259, "<|translate|>": 50359,
                     "<|transcribe|>": 50360, "<|startofprev|>": 50362,
                     "<|notimestamps|>": 50364}
LARGE_V3_TIMESTAMP_BEGIN = 50365
# [large] (b): the card within LARGE_ENC_STEPS bf16 steps of the CPU's
# encoder states after 32 layers.  Base's bound is 8 at 6 layers; on the
# CPU the port's bf16 encoder at d = 1,280 lies 7.49 bf16 steps from an
# fp32 evaluation of the same weights at 6 layers and 13.03 at 32
# (``scripts/torch_encoder_depth.py``): 8 x 13.03 / 7.49 = 13.9.  The
# logits keep base's 5e-2: the prefill reads the CPU's encoder states on
# both sides, and turbo's decoder has 4 layers.
LARGE_ENC_STEPS = 14.0


# The medium and large families' random weights, (model id, seed), in the
# order ``[medium]`` and ``[large]`` use them (distil's as drafts: seed 1).
FAMILY_WEIGHTS = ((SMALL, 0), (MEDIUM, 0), (MEDIUM_EN, 0),
                  (DISTIL_MEDIUM_EN, 1), (LARGE_TURBO, 0), (LARGE_V3, 0),
                  (LARGE_DISTIL, 1))


def _draw_family_weights(executor) -> dict:
    """{model id: a future of its ``init_params`` tree}, drawn in turn on
    ``executor``'s one thread (numpy leaves the GIL while it fills an
    array, 5.3 G normals in all) while the phases run; each phase joins a
    tree before its first use and pops it once done with it."""
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims

    return {m: executor.submit(init_params, get_dims(m), seed=s_)
            for m, s_ in FAMILY_WEIGHTS}


def _gib(n: float) -> str:
    return f"{n * 2 ** -30:.3f} GiB"


def _key_memory(session, key) -> tuple:
    """(state, static inputs, pools) device bytes of ``key``'s loop."""
    from whisper_tpu_torch.runtime import generate

    loop = session.graphs._loops[key]
    return (generate._storage_bytes(loop.state.tensors()),
            generate._storage_bytes(list(loop.inputs)), loop.pool_nbytes)


def _gate_line(dims, memory, rows: int = 16) -> str:
    """A key's state, inputs and pools beside the gate's prediction at
    ``rows`` rows, 132 positions (``utils.hbm``): the caches
    (``decode_footprint``'s kv_cache) and the program's pools
    (``program_pool_bytes``)."""
    from whisper_tpu_torch.utils import hbm

    fp = hbm.decode_footprint(dims, rows, 132, weight_bytes=2, kv_bytes=2,
                              int8_cross=True)
    pool = hbm.program_pool_bytes(dims, rows, 4, act_bytes=2)
    state, inputs, pools = memory
    return (f"state {_gib(state)} against the predicted caches "
            f"{_gib(fp['kv_cache'])} ({state / fp['kv_cache']:.3f}x), inputs "
            f"{_gib(inputs)}, pools {_gib(pools)} against program_pool_bytes "
            f"{_gib(pool)} ({pools / pool:.3f}x); params "
            f"{_gib(fp['params'])}")


def _card_inputs(seed: int):
    """(generator, randn, qweight) on the card from ``seed``: randn(*shape,
    scale) bf16 normals; qweight(rows, cols) int8 steps of 2e-4 in bf16, as
    the encoder passes its dequantized int8 weights."""
    import torch

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(bf)

    def qweight(rows_, cols):
        return (torch.randint(-127, 128, (rows_, cols), generator=g,
                              device="cuda").to(bf)
                * torch.tensor(2e-4, dtype=bf))

    return g, randn, qweight


def _hold_rows(phase: str, cases, shape: dict, results, card: str) -> None:
    """Each of ``cases``, (row, the row's key, kernel, plain, tolerance,
    (bytes, operations, their type), the library call or None, a check
    ``bitwise(got, want)`` or None), against its plain version: finite,
    within its tolerance (in bf16 steps; B5's in absolute terms) and, where
    given, bitwise; then a call timed beside the plain version's, its bound
    and the library call's.  The figures go into the row of ``results``
    under its key; a line each, opened by ``phase``, names ``shape[key]``."""
    import torch

    by_name = {r["name"]: r for r in results}
    for name, at, kern, plain, tol, work, library, bitwise in cases:
        got, want = kern(), plain()
        err = float((got.float() - want.float()).abs().max())
        steps = err if name == "log_mel" else _bf16_steps(got, want)
        if steps > tol or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} at {shape[at]}: {steps:.3g} from "
                                 f"the plain version (tolerance {tol})")
        if bitwise is not None and not bitwise(got, want):
            raise AssertionError(f"{name} at {shape[at]}: not bitwise")
        ms, plain_ms = _median_ms(kern), _median_ms(plain)
        library_ms = None if library is None else _median_ms(library)
        bound_ms, bound_by = _bound(*work)
        by_name[name][at] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}
        print(f"{phase} kernel {name} at {shape[at]}: max_abs_err "
              f"{err:.3g} ({steps:.3g}, tolerance {tol}"
              f"{'' if bitwise is None else '; bitwise'}); {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
              f"{bound_by}"
              + ("" if library_ms is None
                 else f", library call {library_ms:.4f} ms")
              + f" on {card}", flush=True)


def check_large_kernels(card: str, results) -> None:
    """B1, B2c, B3, B4 and B5 at the shapes whisper-large-v3-turbo's main
    path gives them (bucket 16, 20 heads of 64, d = 1,280, f = 5,120, 4
    decoder layers; B5 at 128 mels and 7,680 frames), B1 and B2c beside
    their library call (``scaled_dot_product_attention``; the bf16
    composition of five PyTorch calls that ``check_b2_b3_edges`` times at
    whisper-medium); then B7-i8 at whisper-large-v3's verify pass (16 rows,
    20 heads, five queries: each query bitwise B4's) and B4 at its beam
    rows (beam 2: 32 rows against the cache tiled per beam, each beam
    bitwise the untiled call): each against its plain version within its
    tolerance, a call timed beside the plain version's and its bound.  The
    figures go into the rows of ``results`` (B2c's row is
    ``fused_encoder_mlp_d1024``) under ``at_large_v3_turbo``, B7-i8's
    under ``at_large_v3`` and B4's beam rows under ``at_large_v3_beams``."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import synth_audio
    from whisper_tpu_torch.ops import attention, cross_attention, encoder_mlp
    from whisper_tpu_torch.ops import log_mel, self_attention
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket

    dev = "cuda"
    g, randn, qweight = _card_inputs(5)
    b, h, t, dh, d, f = 16, 20, 1500, 64, 1280, 5120
    n_l, s_max, pos, n, n_q, beams = 4, 132, 70, 16 * 1500, 5, 2
    q, k, v = randn(b, h, t, dh, scale=dh ** -0.5), randn(b, h, t, dh), \
        randn(b, h, t, dh)
    mlp = (randn(b, t, d), 1.0 + randn(d, scale=0.1), randn(d, scale=0.1),
           qweight(d, f), randn(f, scale=0.1), qweight(f, d),
           randn(d, scale=0.1))
    qs, kn, vn = randn(b, h, dh, scale=dh ** -0.5), randn(b, h, dh), \
        randn(b, h, dh)
    kc, vc = randn(n_l, b, h, s_max, dh), randn(n_l, b, h, s_max, dh)
    kc2, vc2 = kc.clone(), vc.clone()
    qx = randn(b, h, dh, scale=dh ** -0.5)
    k8, v8 = (torch.randint(-127, 128, (n_l, b, h, t, dh), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(n_l, b, h, generator=g, device=dev) * 0.02 + 1e-3
              for _ in range(2))
    cross = (k8, v8, ks, vs)
    qm = randn(b, n_q, h, dh, scale=dh ** -0.5)
    # the cache tiled per beam as ``runtime.beam`` tiles it, beam j of row r
    # at r * beams + j (the scales as the [..., 0, 0] views of a [L, B*K,
    # H, 1, 1] tensor)
    tiled = tuple(x.repeat_interleave(beams, dim=1) for x in (k8, v8)) + \
        tuple(x[..., None, None].repeat_interleave(beams, dim=1)[..., 0, 0]
              for x in (ks, vs))
    qb = randn(b * beams, h, dh, scale=dh ** -0.5)
    nv = 7680
    pcm = np.round(np.clip(golden.reflect_pad(synth_audio(
        nv * golden.HOP / 16000.0)), -1, 1) * 32767.0)
    wire = torch.from_numpy(pcm.astype(np.int16)).to(dev)
    nf = mel_frame_bucket(nv)
    tables = sum(x.numel() * x.element_size()
                 for x in log_mel._device_tables(torch.device(dev), 128))
    nnz = log_mel.mel_bands(128)[1].size

    def queries_are_b4s(got, want):
        return all(torch.equal(got[:, i], cross_attention.cross_attend_step(
            qm[:, i].contiguous(), *cross, 2, s_valid=t)) for i in range(n_q))

    def beams_are_untiled(got, want):
        rows = torch.arange(b, device=dev) * beams
        return all(torch.equal(got[rows + j], cross_attention.cross_attend_step(
            qb[rows + j].contiguous(), *cross, 2, s_valid=t))
            for j in range(beams))

    turbo, v3, v3_beams = ("at_large_v3_turbo", "at_large_v3",
                           "at_large_v3_beams")
    cases = [
        ("fused_attention", turbo,
         lambda: attention.fused_attention(q, k, v),
         lambda: attention.fused_attention_plain(q, k, v), 2.0,
         (4 * b * h * t * dh * 2, 4 * b * h * t * t * dh, "bf16"),
         lambda: torch.nn.functional.scaled_dot_product_attention(
             q, k, v, scale=1.0), None),
        ("fused_encoder_mlp_d1024", turbo,
         lambda: encoder_mlp.fused_encoder_mlp(*mlp),
         lambda: encoder_mlp.fused_encoder_mlp_plain(*mlp), 2.0,
         ((2 * n * d + 2 * d * f + 3 * d + f) * 2, 4 * n * d * f, "bf16"),
         lambda: _encoder_mlp_composition(*mlp), None),
        ("self_attend_step", turbo,
         lambda: self_attention.self_attend_step(qs, kn, vn, kc, vc, 3, pos),
         lambda: self_attention.self_attend_step_plain(qs, kn, vn, kc2, vc2,
                                                       3, pos), 2.0,
         (b * h * dh * 2 * (2 * (pos + 1) + 6), 4 * b * h * (pos + 1) * dh,
          "fp32"), None,
         lambda got, want: torch.equal(kc, kc2) and torch.equal(vc, vc2)),
        ("cross_attend_step", turbo,
         lambda: cross_attention.cross_attend_step(qx, *cross, 2, s_valid=t),
         lambda: cross_attention.cross_attend_step_plain(qx, *cross, 2,
                                                         s_valid=t), 2.0,
         (b * h * (2 * t * dh + 2 * dh * 2 + 8), 4 * b * h * t * dh, "int8"),
         None, None),
        ("log_mel", turbo, lambda: log_mel.log_mel(wire, nv, 128, nf),
         lambda: log_mel.log_mel_plain(wire, nv, 128, nf), 1e-4,
         (((nv - 1) * golden.HOP + golden.WIN) * 2 + 128 * nf * 4 + tables,
          nv * (2.5 * 400 * np.log2(400) + 3 * 201 + 2 * nnz), "fp32"),
         None, None),
        ("cross_attend_multi", v3,
         lambda: cross_attention.cross_attend_multi(qm, *cross, 2, s_valid=t,
                                                    int8_mxu=True),
         lambda: cross_attention.cross_attend_multi_plain(
             qm, *cross, 2, s_valid=t, int8_mxu=True), 2.0,
         (b * h * (2 * t * dh + 8) + 2 * b * n_q * h * dh * 2,
          4 * b * n_q * h * t * dh, "int8"), None, queries_are_b4s),
        ("cross_attend_step", v3_beams,
         lambda: cross_attention.cross_attend_step(qb, *tiled, 2, s_valid=t),
         lambda: cross_attention.cross_attend_step_plain(qb, *tiled, 2,
                                                         s_valid=t), 2.0,
         (b * beams * h * (2 * t * dh + 2 * dh * 2 + 8),
          4 * b * beams * h * t * dh, "int8"), None, beams_are_untiled),
    ]
    shape = {turbo: "large-v3-turbo's shape",
             v3: f"large-v3's verify pass ({b} rows, {h} heads, {n_q} "
                 "queries; each query bitwise B4's)",
             v3_beams: f"large-v3's {b * beams} beam rows (the cache tiled "
                       "per beam; each beam bitwise the untiled call)"}
    _hold_rows("[large]", cases, shape, results, card)


def _bucket_launches(c: dict, cond: int, dims, label: str) -> int:
    """A bucket's launches by the capture's tally: B1 and B2 once an
    encoder layer (one program launch), B3 and B4 once a decoder layer and
    step run (the tail once a step), C once, no B5; the steps run."""
    steps = c["loop_tail"]
    want = {"fused_attention": dims.encoder_layers,
            "fused_encoder_mlp": dims.encoder_layers,
            "self_attend_step": dims.decoder_layers * steps,
            "cross_attend_step": dims.decoder_layers * steps, "log_mel": 0}
    if steps < 1 or cond != 1 or any(c[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {c}, C {cond}; want "
                             f"{want}, C 1")
    return steps


def _large_v3_added_tokens() -> list:
    """large-v3's special ids as a tokenizer.json's ``added_tokens``."""
    return [{"id": i, "content": t, "special": True}
            for t, i in LARGE_V3_SPECIALS.items()]


def _large_speculative(card: str, results, session, params, draft, audio,
                       greedy) -> dict:
    """``[large]`` (e): whisper-large-v3 (``session``: (c)'s, x5) decoding
    the 301.574 s file speculatively, draft_k 4, with three drafts in turn:
    distil-large-v3 (``draft``, random weights) on its own encoder and on
    the main one (``share_encoder``), and large-v3's own int8 weights on
    the main encoder (``params``: a draft whose proposals the verify pass
    nearly always accepts).  For each: a graphed run after the capture,
    and with distil on the shared encoder an eager one, tokens bitwise,
    rounds and launches equal (the drafts' tokens are bitwise equal, so one
    eager run holds all three); rounds counted (``speculative_stats``) and
    rounds run (B7 launches over 32 layers) equal, one graph launch; B1 and
    B2 once a main encoder layer, B7 once a
    layer and round run, B4 once a draft layer, draft step and round run,
    no B3; e2e, x real time, capture seconds, on the shared encoder ms a
    round run of the bucket's decode on its encoder states (graphed, host
    clock, the prefills and a round taken out; on its own encoder the
    draft's round is the same), the key's state and pools beside
    ``speculative_footprint`` and ``program_pool_bytes``.  The drafts'
    tokens must be bitwise equal, and each chunk that differs from (c)'s
    greedy tokens (``greedy``) is judged by ``divergence_report``
    (``_judge``): a first divergence that is not a tie-flip fails.
    Returns the B7 launches of each draft's graphed run."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import AUDIO_SECONDS, run_once
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.utils import hbm
    from whisper_tpu_torch.variants.quant import quantize_params

    dims, k = session.dims, 4
    n_l = dims.decoder_layers
    d_dims = get_dims(LARGE_DISTIL)
    # (label, the draft's weights and dims, share_encoder, an eager run)
    arms = (("a random distil-large-v3 on its own encoder", draft, d_dims,
             False, False),
            ("the same on the shared encoder", draft, d_dims, True, True),
            ("large-v3's own int8 weights on the shared encoder",
             quantize_params({"decoder": params["decoder"]}), dims, True,
             False))
    special = special_tokens("en", "transcribe", None)
    eot = special.eot
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    prompt_t = torch.tensor(prompt, device="cuda")
    gen_cfg = GenerationCfg()
    masks = session._get_masks(gen_cfg.suppress_tokens,
                               gen_cfg.begin_suppress_tokens)
    chunks = _bucket_chunks(session, audio)
    enc = session.encoder(chunks)

    def decode_s(n_new):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        session._speculative_tokens(chunks, enc, prompt_t, *masks, n_new, eot,
                                    k)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    tokens, b7 = {}, {}
    for label, d_params, dd, share, eager in arms:
        session.set_draft_model(d_params, dd, share_encoder=share)
        run_once(session, audio, speculative=True, draft_k=k)   # captures
        (key, capture_s), = [(kk, s) for kk, s in
                             session.graphs.captures().items()
                             if kk.kind == "speculative"]
        runs = {}
        for mode in ("graphed", "eager") if eager else ("graphed",):
            _zero_counts(results)
            col = []
            with _graph_launches() as launches, (
                    _eager_loop(session) if mode == "eager"
                    else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run_once(session, audio, token_collector=col,
                         speculative=True, draft_k=k)
                e2e = time.perf_counter() - t1
            rounds = int(sum(r for r, _ in session.speculative_stats))
            # tokens committed a row (the bucket's padding rows too)
            committed = np.concatenate([c_.cpu().numpy() for _, c_ in
                                        session.speculative_stats]).mean()
            runs[mode] = (e2e, col[0], _counts(results), len(launches),
                          rounds, committed)
        (g_s, toks, c, g_launch, rounds, committed) = runs["graphed"]
        (e_s, e_toks, e_c, e_launch, e_rounds, _) = runs.get(
            "eager", (None, toks, c, 0, rounds, None))
        ran = c["cross_attend_multi"] // n_l
        want = {"fused_attention": dims.encoder_layers,
                "fused_encoder_mlp": dims.encoder_layers,
                "cross_attend_multi": n_l * rounds,
                "cross_attend_step": dd.decoder_layers * k * rounds,
                "self_attend_step": 0, "loop_tail": 0}
        if not (np.array_equal(toks, e_toks) and c == e_c
                and rounds == e_rounds == ran and g_launch == 1
                and e_launch == 0
                and all(c[n] == v for n, v in want.items())):
            raise AssertionError(
                f"[large] (e) {label}: tokens bitwise "
                f"{np.array_equal(toks, e_toks)}, rounds {rounds} / "
                f"{e_rounds} counted, {ran} run, graph launches {g_launch} / "
                f"{e_launch}, launches {c} / {e_c}; want {want}")
        tokens[label], b7[label] = toks, c["cross_attend_multi"]
        # the key's memory before the bucket's decode adds two keys (the
        # budget may then drop it)
        state, inputs, pools = _key_memory(session, key)
        fp = session.speculative_footprint(dd, share)
        rounds_line = ""
        if share:     # a round on the draft's own encoder is the same round
            decode_s(1)
            decode_s(128)                          # captures both keys
            _zero_counts(results)
            whole = decode_s(128)
            run_rounds = _counts(results)["cross_attend_multi"] // n_l
            round_ms = (whole - decode_s(1)) * 1e3 / (run_rounds - 1)
            rounds_line = (f"; the bucket's decode {round_ms:.4f} ms a round "
                           f"run graphed ({run_rounds} rounds; host clock, "
                           f"the prefills and a round taken out)")
        pool_est = hbm.program_pool_bytes(dims, 16, 4, act_bytes=2,
                                          draft_dims=None if share else dd)
        caches = fp["kv_cache"] + fp["draft_kv_cache"]
        print(f"[large] (e) whisper-large-v3 x5 with {label} as draft, draft_k"
              f" {k}, the 301.574 s file, on {card}: e2e graphed {g_s:.4f} s "
              f"({AUDIO_SECONDS / g_s:.2f}x real time)"
              + ("" if e_s is None else f", eager {e_s:.4f} s, tokens "
                 "bitwise, launches equal")
              + f"; one graph launch; {rounds} "
              f"rounds counted and run, {committed / rounds:.3f} tokens "
              f"committed a round and row; launches {c}; capture "
              f"{capture_s:.2f} s{rounds_line}; the key: state "
              f"{_gib(state)} against the footprint's caches {_gib(caches)} "
              f"({state / caches:.3f}x), inputs {_gib(inputs)}, pools "
              f"{_gib(pools)} against program_pool_bytes {_gib(pool_est)} "
              f"({pools / pool_est:.3f}x); speculative_footprint total "
              f"{_gib(fp['total'])}", flush=True)
    first, *rest = tokens.values()
    if any(not np.array_equal(first, t) for t in rest):
        raise AssertionError("[large] (e): the tokens depend on the draft")
    nv = golden.num_frames(len(audio))
    mel = session.compute_mel(golden.reflect_pad(audio), nv,
                              mel_frame_bucket(nv))
    starts = [p // golden.HOP for p in chunk_starts(len(audio), 480_000,
                                                    400_000)]
    verdict = _judge(session, session, mel, [(s, prompt) for s in starts],
                     greedy, first, eot, "speculative large-v3")
    print(f"[large] (e) the three drafts' tokens bitwise equal; against (c)'s"
          f" greedy tokens: {float((first == greedy).mean()):.4f} of "
          f"{first.size} equal, " + _judge_line(verdict), flush=True)
    if verdict[4]:
        raise AssertionError(f"[large] (e): divergences from greedy that are "
                             f"not tie-flips: {verdict[4]}")
    return b7


def _large_beams(card: str, results, session, audio) -> int:
    """``[large]`` (f): whisper-large-v3 (``session``, x5) translating the
    301.574 s file with beam 2 and timestamps, large-v3's own special ids
    (``LARGE_V3_SPECIALS`` through a tokenizer that holds them): 12 chunks
    in a bucket of 16, 32 beam rows against the cross cache tiled per beam.
    A graphed run through ``transcribe_longform`` after the capture and an
    eager one: tokens bitwise (timestamps included), launches equal, one
    graph launch, B4 once a decoder layer and step run, no B3; every row
    within the timestamp grammar (``_grammar_errors``: timestamps from
    50,365, never decreasing, pairs closed); the bucket's beam decode on its
    encoder states (``beam_generate``, 128 tokens, no read) graphed and
    eager: tokens and scores bitwise, ms a step of each (host clock, the
    prefill taken out); the body's nodes, the self cache's gather a step
    (the step's ``index_select`` and ``copy_`` of self_k and self_v over
    the key's own cache) in device µs, the key's state and pools, and the
    prompt's ids as the program holds them.  Returns the B4 launches of
    the graphed run."""
    import numpy as np
    import torch

    from whisper_tpu_torch.headline import AUDIO_SECONDS
    from whisper_tpu_torch.pipeline.longform import transcribe_longform
    from whisper_tpu_torch.runtime.beam import beam_generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.timestamps import TimestampCfg
    from whisper_tpu_torch.tokenizer.bpe import WhisperDetokenizer
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.utils import hbm

    dims, beams = session.dims, 2
    n_l = dims.decoder_layers
    tok = WhisperDetokenizer({}, _large_v3_added_tokens())
    special = special_tokens("en", "translate", tok)
    ts_cfg = TimestampCfg(special.no_timestamps + 1, special.eot,
                          special.no_timestamps)
    if ts_cfg.timestamp_begin != LARGE_V3_TIMESTAMP_BEGIN:
        raise AssertionError(f"[large] (f): timestamps from "
                             f"{ts_cfg.timestamp_begin}")

    def run(eager):
        col = []
        with _graph_launches() as launches, (
                _eager_loop(session) if eager else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, timing = transcribe_longform(
                session, audio, "en", "translate", 128, tokenizer=tok,
                timestamps=True, num_beams=beams, token_collector=col)
            e2e = time.perf_counter() - t1
        return e2e, timing, col[0], len(launches)

    run(False)                                     # captures the bucket's key
    (key, capture_s), = [(kk, s) for kk, s in
                         session.graphs.captures().items()
                         if kk.kind == "beam"]
    runs = {}
    for mode in ("graphed", "eager"):
        _zero_counts(results)
        runs[mode] = run(mode == "eager") + (_counts(results),)
    (g_s, timing, toks, g_launch, c), (e_s, _, e_toks, e_launch, e_c) = \
        runs["graphed"], runs["eager"]
    steps = c["cross_attend_step"] // n_l
    if not (np.array_equal(toks, e_toks) and c == e_c and g_launch == 1
            and e_launch == 0 and key.rows == 16 * beams
            and c["cross_attend_step"] == n_l * steps and 0 < steps <= 127
            and c["self_attend_step"] == 0 and c["loop_tail"] == 0):
        raise AssertionError(
            f"[large] (f): tokens bitwise {np.array_equal(toks, e_toks)}, "
            f"graph launches {g_launch} / {e_launch}, rows {key.rows}, "
            f"launches {c} / {e_c}")
    errs = [(r, e) for r, row in enumerate(toks)
            for e in _grammar_errors(row, ts_cfg)]
    if errs:
        raise AssertionError(f"[large] (f): rows break the timestamp "
                             f"grammar: {errs[:8]}")
    loop = session.graphs._loops[key]
    prompt_ids = loop.inputs[-3].tolist()      # prompt, suppress, first mask
    if prompt_ids != [special.sot, special.lang, special.task]:
        raise AssertionError(f"[large] (f): the program's prompt {prompt_ids}")
    body_ops, memory = loop.body_ops, _key_memory(session, key)

    # the bucket's beam decode on its encoder states, 127 steps, no read
    enc = session.encoder(_bucket_chunks(session, audio))
    gen_cfg = GenerationCfg()
    masks = session._get_masks(gen_cfg.suppress_tokens,
                               gen_cfg.begin_suppress_tokens)
    prompt_t = torch.tensor(prompt_ids, device="cuda")

    def decode(n_new, eager):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = beam_generate(
            session._decoder_params, dims, enc, prompt_t, *masks, n_new,
            special.eot, beams, ts_cfg=ts_cfg, int8_cross_kv=True,
            packed_cross=True, int8_mxu=True, early_exit=False, eager=eager,
            graphs=session.graphs)
        torch.cuda.synchronize()
        return time.perf_counter() - t1, out

    decode(1, False)
    decode(128, False)                             # captures both keys
    step_ms, outs = {}, {}
    for mode in ("graphed", "eager"):
        pre, _ = decode(1, mode == "eager")
        whole, outs[mode] = decode(128, mode == "eager")
        step_ms[mode] = (whole - pre) * 1e3 / 127
    if not all(torch.equal(a, b) for a, b in zip(outs["graphed"],
                                                 outs["eager"])):
        raise AssertionError("[large] (f): the bucket's beam decode graphed "
                             "differs from eager (tokens or scores)")
    # the step's gather of the self cache after its parent beams, alone, on
    # the bucket decode's own cache (the next launch's prefill writes it
    # anew; the long-form key may have left the budget by now)
    (state_128,) = [lp.state for kk, lp in session.graphs._loops.items()
                    if kk.kind == "beam" and kk.front[0] == "states"
                    and kk.max_new_tokens == 128]
    sk, sv = state_128.cache.self_k, state_128.cache.self_v
    rows = torch.arange(key.rows, device="cuda").view(-1, beams).flip(1) \
        .reshape(-1)

    def gather():
        sk.copy_(sk.index_select(1, rows))
        sv.copy_(sv.index_select(1, rows))

    gather_us = _median_ms(gather, calls=10) * 1e3
    cache_bytes = sk.numel() * sk.element_size() * 2
    state, inputs, pools = memory
    caches = hbm.kv_cache_bytes(dims, key.rows, key.prompt_len + 128,
                                int8_cross=True)
    pool_est = hbm.program_pool_bytes(dims, 16, key.prompt_len, act_bytes=2)
    stamps = toks[toks >= ts_cfg.timestamp_begin]
    print(f"[large] (f) whisper-large-v3 x5, beam {beams}, timestamps, "
          f"translate, the 301.574 s file ({key.rows} beam rows), on {card}: "
          f"the prompt's ids {prompt_ids}, timestamps from "
          f"{ts_cfg.timestamp_begin}; e2e graphed {g_s:.4f} s "
          f"({AUDIO_SECONDS / g_s:.2f}x real time; model "
          f"{timing.model_only_s:.4f} s), eager {e_s:.4f} s; tokens bitwise "
          f"(timestamps included), launches equal {c} ({steps} steps run), "
          f"one graph launch; every row within the grammar, {stamps.size} "
          f"timestamps ({int(stamps.min()) if stamps.size else None} to "
          f"{int(stamps.max()) if stamps.size else None}); capture "
          f"{capture_s:.2f} s; the body's nodes {body_ops}; the bucket's beam"
          f" decode, tokens and scores bitwise, {step_ms['graphed']:.4f} ms a"
          f" step graphed, {step_ms['eager']:.4f} eager (host clock, prefill "
          f"taken out); the self cache's gather {gather_us:.1f} µs a step on "
          f"the card ({4 * cache_bytes / gather_us * 1e-3:.0f} GB/s over "
          f"{_gib(4 * cache_bytes)} read and written); the key: state "
          f"{_gib(state)} against the caches at {key.rows} rows "
          f"{_gib(caches)} ({state / caches:.3f}x), inputs {_gib(inputs)}, "
          f"pools {_gib(pools)} against program_pool_bytes {_gib(pool_est)} "
          f"({pools / pool_est:.3f}x)", flush=True)
    return c["cross_attend_step"]


def _large_distil(card: str, results, params, audio) -> None:
    """``[large]`` (g), (h): distil-large-v3 (32 encoder layers, 2 decoder
    layers; ``params``) at x5.  (g) serving: the engine at max_batch 16
    with trimmed uploads, warmed (``warmup``: buckets 1 to 16 at four ship
    lengths, 20 programs, each holding the 32-layer encoder); the keys kept
    after it and their state, inputs and pools against the budget; a burst
    of 16 clips of 1-30 s, each row equal to the clip alone at bucket 1 or
    its first divergence a judged tie-flip (``_judge_rows``); then 32
    concurrent streams of 30 s, three reps (``serve_bench.run_bench``):
    aggregate x real time, latency p50 and p95; no key captured after the
    warm-up.  (h) the 301.574 s file: a warm-up and three timed runs, one
    graph launch a bucket, launches by the capture's tally (B1 = B2 = 32 a
    program launch, B3 = B4 = 2 a step run, the tail once a step, C once),
    an eager run bitwise the graphed tokens with equal launches."""
    import numpy as np
    import torch

    from whisper_tpu_torch.headline import AUDIO_SECONDS, make_session, run_once
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.runtime.genconfig import GenerationCfg
    from whisper_tpu_torch.runtime.generate import strip_generated
    from whisper_tpu_torch.serve import serve_bench
    from whisper_tpu_torch.serve.engine import EngineConfig, StreamingEngine
    from whisper_tpu_torch.tokenizer.specials import special_tokens

    dims = get_dims(LARGE_DISTIL)
    session = make_session("cuda", params, "x5", LARGE_DISTIL)
    special = special_tokens("en", "transcribe", None)
    prompt = [special.sot, special.lang, special.task, special.no_timestamps]
    eot = special.eot
    gen = GenerationCfg()
    budget = generate._budget(session.device)

    # (g) the engine's short lane
    eng = StreamingEngine(session, cfg=EngineConfig(max_new_tokens=128,
                                                    batch_window_ms=20))
    try:
        t1 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t1
        warm, kept = session.graphs.captures(), session.graphs.kept()
        pools = session.graphs.pools()
        short = [kk for kk in warm if kk.front[0] == "short audio"]
        if len(short) != 20 or set(kept) != set(warm):
            raise AssertionError(f"[large] (g): {len(short)} short programs "
                                 f"captured, {len(kept)} kept after the "
                                 f"warm-up")
        clips = _serve_clips(16, seed=14)
        _zero_counts(results)
        t1 = time.perf_counter()
        texts, lat = _latencies(eng, clips)
        wall = time.perf_counter() - t1
        c = _counts(results)
        if any(c[n] == 0 for n in ("fused_attention", "fused_encoder_mlp",
                                   "self_attend_step", "cross_attend_step")) \
                or c["log_mel"]:
            raise AssertionError(f"[large] (g) the burst: launches {c}")

        def alone(clip):
            toks = session.transcribe_short_batch(
                *_one_row(clip), prompt, 128, eot,
                suppress_ids=gen.suppress_tokens,
                begin_suppress_ids=gen.begin_suppress_tokens)
            return strip_generated(toks[0], eot)

        verdict = _judge_rows(session, clips, prompt, eot,
                              [_engine_tokens(t) for t in texts],
                              [alone(a) for a in clips],
                              "(g) batched against alone")
        reps = serve_bench.run_bench(eng, serve_bench.make_streams(32, 30.0),
                                     reps=3)
        after = session.graphs.captures()
        captured = [kk for kk, s_ in after.items() if warm.get(kk) != s_]
        if captured or set(after) != set(warm):
            raise AssertionError(f"[large] (g): {len(captured)} keys "
                                 "captured after the warm-up, "
                                 f"{len(set(warm) - set(after))} dropped")
    finally:
        eng.close()
    print(f"[large] (g) distil-large-v3 x5 serving, max_batch 16, trimmed "
          f"uploads, on {card}: warm-up {warm_s:.1f} s, {len(short)} "
          f"programs kept (state, inputs and pools "
          f"{_gib(sum(kept.values()))}, of it pools "
          f"{_gib(sum(pools.values()))}, against the budget {_gib(budget)}; "
          f"pools a bucket-16 program "
          + ", ".join(_gib(pools[kk]) for kk in short if kk.rows == 16)
          + f"); a burst of 16 clips of 1-30 s: wall {wall:.4f} s, latency "
          f"p50 {_pct(lat, 0.5):.4f} s p95 {_pct(lat, 0.95):.4f} s, "
          f"{verdict} against each clip alone at bucket 1; launches {c}",
          flush=True)
    for i, r in enumerate(reps):
        print(f"[large] (g) distil-large-v3 x5, 32 streams x 30 s, rep {i}, "
              f"on {card}: wall {r['wall_s']:.4f} s, {r['x_real_time']:.2f}x "
              f"real time aggregate, latency p50 {r['p50_s']:.4f} s p95 "
              f"{r['p95_s']:.4f} s max {r['max_s']:.4f} s, ticks so far "
              f"{r['ticks']}", flush=True)
    print(f"[large] (g) keys captured after the warm-up: 0 (of "
          f"{len(after)} kept)", flush=True)

    # (h) the 301.574 s file
    e2e, timing, toks, c = _timed_run(session, audio, results, runs=3)
    steps = _bucket_launches(c, _condition_count(), dims,
                             "[large] (h) graphed")
    (capture_s,) = [s_ for kk, s_ in session.graphs.captures().items()
                    if kk.front[0] == "chunks"]
    with _graph_launches() as launches:
        run_once(session, audio)
    with _eager_loop(session):
        _zero_counts(results)
        col = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_once(session, audio, token_collector=col)
        eager_s = time.perf_counter() - t1
        eager_c = _counts(results)
    if len(launches) != 1 or not np.array_equal(col[0], toks) \
            or eager_c != c:
        raise AssertionError(f"[large] (h): {len(launches)} graph launches, "
                             f"eager tokens bitwise "
                             f"{np.array_equal(col[0], toks)}, launches "
                             f"{eager_c} / {c}")
    print(f"[large] (h) distil-large-v3 x5, the 301.574 s file, 12 chunks in "
          f"a bucket of 16, on {card}: e2e {e2e:.4f} s (median of 3), "
          f"{AUDIO_SECONDS / e2e:.2f}x real time, model "
          f"{timing.model_only_s:.4f} s; eager {eager_s:.4f} s, tokens "
          f"bitwise the graphed run's, launches equal; one graph launch; "
          f"launches {c} ({steps} steps run); capture {capture_s:.2f} s",
          flush=True)


def _large_cli(card: str, results, params) -> dict:
    """``[large]`` (i): the CLI at whisper-large-v3 (``--allow-random-init``:
    its weights from seed 0, ``params``, the tree drawn for (c) handed back
    by ``_drawn_weights``) with ``--num-beams 2 --timestamps
    --task translate`` over the 76 s WAV (B5 at 128 mels), large-v3's
    special ids read from a tokenizer.json that holds them
    (``--tokenizer-json``): per-file e2e, the Timing split and the peak
    above its start (``run_cli``); B1 and B2 32 a program launch, B4 and no
    B3 (beam search's step), no B6; the row's text holds timestamps.
    Returns the counts."""
    from whisper_tpu_torch.models.registry import get_dims

    files = (CLI_FILES[2],)
    label = "large-v3-x5-beams2-timestamps-translate"
    with tempfile.TemporaryDirectory() as tmp, _drawn_weights(
            (get_dims(LARGE_V3), 0, params)):
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        _write_wav(os.path.join(audio_dir, files[0][0]), *files[0][1:])
        tok_json = os.path.join(tmp, "tokenizer.json")
        with open(tok_json, "w") as f:
            json.dump({"model": {"vocab": {}},
                       "added_tokens": _large_v3_added_tokens()}, f)
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        c = run_cli(label, card, results, audio_dir, tmp,
                    ["--model-id", LARGE_V3, "--max-new-tokens", "128",
                     "--variant", "x5", "--num-beams", "2", "--timestamps",
                     "--task", "translate", "--tokenizer-json", tok_json],
                    files=files)
        with open(os.path.join(tmp, label, "c.csv")) as f:
            text = list(csv.reader(f))[1][4]
    if not (c["fused_attention"] > 0 and c["fused_attention"] % 32 == 0
            and c["fused_encoder_mlp"] == c["fused_attention"]
            and c["cross_attend_step"] > 0 and c["self_attend_step"] == 0
            and c["cross_attend_step_dequant"] == 0 and "<|" in text):
        raise AssertionError(f"[large] (i) the CLI at large-v3 with beams, "
                             f"timestamps and translate: launches {c}, text "
                             f"{text[:200]!r}")
    print(f"[large] (i) the CLI's text at large-v3 opens {text[:80]!r} (text "
          "tokens decode to nothing: the tokenizer.json holds the special "
          "ids alone)", flush=True)
    return c


def check_large(card: str, results, drawn: dict) -> None:
    """``[large]``: the large family's main path on the card at full width
    (see the module's docstring, 8e); ``drawn``: ``_draw_family_weights``'s
    futures, whose trees this phase takes and lets go."""
    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        make_session,
        run_once,
        synth_audio,
    )
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.pipeline.chunk import mel_frame_bucket
    from whisper_tpu_torch.runtime import generate
    from whisper_tpu_torch.tokenizer.specials import special_tokens
    from whisper_tpu_torch.utils import hbm

    t_phase = time.perf_counter()
    secs = {}
    check_large_kernels(card, results)
    secs["kernels"] = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    dims = get_dims(LARGE_TURBO)
    turbo = drawn.pop(LARGE_TURBO).result()
    secs["turbo weights, waited for"] = time.perf_counter() - t0
    session = make_session("cuda", turbo, "x5", LARGE_TURBO)
    weights = torch.cuda.memory_allocated() - base

    # (b) the card against the port on the CPU: one 30 s chunk
    t0 = time.perf_counter()
    check_against_cpu(turbo, dims, LARGE_TURBO, seconds=30.0, steps=4,
                      enc_steps_tol=LARGE_ENC_STEPS, card_session=session)
    secs["(b)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = drawn.pop(LARGE_V3).result()
    secs["large-v3 weights, waited for"] = time.perf_counter() - t0

    # (a) turbo on the 301.574 s file, one bucket of 16
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    audio = synth_audio(AUDIO_SECONDS)
    e2e, timing, toks, c, steps, capture_s, eager_s, memory = _file_runs(
        session, audio, results, "[large] (a)")
    peak = torch.cuda.max_memory_allocated() - base
    # the eager decode traced, and in the same trace five one-shot mels of
    # 76.8 s (B5 at 128 mels, 7,680 frames): a short trace of its own may
    # record no device time at all
    short = synth_audio(76.8)
    nv = golden.num_frames(len(short))
    padded = golden.reflect_pad(short)
    with _eager_loop(session):
        traced = _traced(lambda: (run_once(session, audio), [
            session.compute_mel(padded, nv, mel_frame_bucket(nv))
            for _ in range(5)]))
    _note_in_situ(traced, results, "at_large_v3_turbo", b5=True)
    secs["(a)"] = time.perf_counter() - t0
    print(f"[large] (a) whisper-large-v3-turbo x5, {AUDIO_SECONDS} s, 12 "
          f"chunks in a bucket of 16, on {card}: e2e {e2e:.4f} s (median of "
          f"3), {AUDIO_SECONDS / e2e:.2f}x real time, preprocess "
          f"{timing.preprocess_s:.4f} s, model {timing.model_only_s:.4f} s; "
          f"eager {eager_s:.4f} s, tokens bitwise the graphed run's; one "
          f"graph launch a bucket; launches {c} ({steps} steps run; B1, B2 "
          f"{dims.encoder_layers} a program launch, B3, B4 "
          f"{dims.decoder_layers} a step, no B5); capture {capture_s:.2f} s; "
          f"the key: {_gate_line(dims, memory)}; weights {_gib(weights)}, "
          f"peak {_gib(peak)} above the phase's start; in situ, µs "
          f"(launches), the eager run and five one-shot mels of {nv} frames "
          f"at 128 mels: {_in_situ(traced)}", flush=True)
    del session
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (c) whisper-large-v3 (32 decoder layers) on the same file
    t0 = time.perf_counter()
    dims = get_dims(LARGE_V3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    session = make_session("cuda", params, "x5", LARGE_V3)
    run_once(session, audio)                      # captures the bucket's key
    (key, capture_s), = session.graphs.captures().items()
    runs = {}
    for mode in ("graphed", "eager"):
        _zero_counts(results)
        col = []
        with _graph_launches() as launches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if mode == "eager":
                with _eager_loop(session):
                    run_once(session, audio, token_collector=col)
            else:
                run_once(session, audio, token_collector=col)
            e2e = time.perf_counter() - t1
        runs[mode] = (e2e, col[0], _counts(results), len(launches),
                      _condition_count())
    (g_s, g_toks, g_c, g_launch, g_cond), (e_s, e_toks, e_c, e_launch, _) = \
        runs["graphed"], runs["eager"]
    if not np.array_equal(g_toks, e_toks) or g_c != e_c or g_launch != 1 \
            or e_launch != 0:
        raise AssertionError(f"[large] (c): tokens bitwise "
                             f"{np.array_equal(g_toks, e_toks)}, launches "
                             f"{g_c} / {e_c}, graph launches {g_launch} / "
                             f"{e_launch}")
    steps = _bucket_launches(g_c, g_cond, dims, "[large] (c) graphed")
    check_main_path_finite(session, audio, dims)
    loop = session.graphs._loops[key]
    memory = _key_memory(session, key)
    # ms a step of the bucket's decode on its encoder states, graphed and
    # eager: 128 tokens less 1, over 127 steps (no row ending)
    enc, _ = _bucket_encoder_states(session, audio)
    special = special_tokens("en", "transcribe", None)
    prompt_t = torch.tensor([special.sot, special.lang, special.task,
                             special.no_timestamps], device="cuda")
    masks = session._get_masks([], [])

    def decode_s(n_new, eager):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if eager:
            with _eager_loop(session):
                session._greedy(enc, prompt_t, *masks, n_new, special.eot,
                                early_exit=False)
        else:
            session._greedy(enc, prompt_t, *masks, n_new, special.eot,
                            early_exit=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    step_ms = {}
    for eager in (False, True):
        if not eager:                         # captures (the eager loop is
            decode_s(1, eager)                # warm from the run above)
            decode_s(128, eager)
        step_ms[eager] = (decode_s(128, eager) - decode_s(1, eager)) * 1e3 \
            / 127
    footprint = hbm.decode_footprint(
        dims, 16, 132, weight_bytes=2, kv_bytes=2, int8_cross=True,
        graph_pool=memory[2], graph_kept=generate._budget(session.device))
    warn = hbm.check_fit(footprint, device=session.device)
    peak = torch.cuda.max_memory_allocated() - base
    kept = session.graphs.kept()
    secs["(c)"] = time.perf_counter() - t0
    print(f"[large] (c) whisper-large-v3 x5 (32 decoder layers), the same "
          f"file, on {card}: e2e graphed {g_s:.4f} s, eager {e_s:.4f} s, "
          f"tokens bitwise, launches equal {g_c} ({steps} steps run), one "
          f"graph launch; capture {capture_s:.2f} s; the body's nodes "
          f"{loop.body_ops}; the bucket's decode {step_ms[False]:.4f} ms a "
          f"step graphed, {step_ms[True]:.4f} eager (host clock, prefill "
          f"taken out); the key: {_gate_line(dims, memory)}; check_fit at "
          f"bucket 16 with that key's pools and the budget other keys may "
          f"keep ({_gib(footprint['total'])} of "
          f"{_gib(hbm.device_hbm_budget(session.device))}): "
          + ("passes" if warn is None else f"warns: {warn}")
          + f"; {len(kept)} keys kept, {_gib(sum(kept.values()))} against "
          f"the budget {_gib(generate._budget(session.device))}; peak "
          f"{_gib(peak)} above the part's start", flush=True)
    del enc

    # (e) speculative decoding and (f) beams on (c)'s session
    t0 = time.perf_counter()
    draft = drawn.pop(LARGE_DISTIL).result()
    secs["distil-large-v3 weights, waited for"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b7 = _large_speculative(card, results, session, params, draft, audio,
                            g_toks)
    secs["(e)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b4 = _large_beams(card, results, session, audio)
    secs["(f)"] = time.perf_counter() - t0
    by_name = {r["name"]: r for r in results}
    by_name["cross_attend_multi"]["at_large_v3"]["launches"] = b7
    by_name["cross_attend_step"]["at_large_v3_beams"]["launches"] = b4
    del session
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (i) the CLI at large-v3 with beams, timestamps and translate, on the
    # weights (c) drew
    t0 = time.perf_counter()
    _large_cli(card, results, params)
    del params
    secs["(i)"] = time.perf_counter() - t0

    # (d) the CLI at turbo over one WAV (76 s: the one-shot front end, B5,
    # at 128 mels), on the weights (a) ran
    t0 = time.perf_counter()
    files = (CLI_FILES[2],)
    with tempfile.TemporaryDirectory() as tmp, _drawn_weights(
            (get_dims(LARGE_TURBO), 0, turbo)):
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        _write_wav(os.path.join(audio_dir, files[0][0]), *files[0][1:])
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        c = run_cli("large-v3-turbo-x5", card, results, audio_dir, tmp,
                    ["--model-id", LARGE_TURBO, "--max-new-tokens", "128",
                     "--variant", "x5"], files=files)
    if not (c["log_mel"] > 0 and c["fused_attention"] > 0
            and c["fused_encoder_mlp"] > 0
            and c["self_attend_step"] == c["cross_attend_step"] > 0
            and c["cross_attend_step_dequant"] == 0):
        raise AssertionError(f"[large] (d) the CLI at turbo: launches {c}")
    del turbo
    secs["(d)"] = time.perf_counter() - t0

    # (g) distil-large-v3 serving, (h) on the 301.574 s file
    t0 = time.perf_counter()
    _large_distil(card, results, draft, audio)
    del draft
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    secs["(g), (h)"] = time.perf_counter() - t0
    secs["phase"] = time.perf_counter() - t_phase
    print("[large] seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in secs.items()),
          flush=True)


# [wire]: every upload wire of ``RuntimeCfg.audio_transfer``
WIRES = ("f32", "int16", "dint16", "dint16p", "ulaw8", "pcm12", "pcm14")
LOSSLESS = ("dint16", "dint16p")      # decode to int16's samples bit for bit


def _wire_upload(session, padded, n_valid: int) -> tuple:
    """The streamed front end's upload of a file in the session's wire,
    slab by slab as ``compute_mel_streamed`` ships it, three times: (bytes
    shipped, host encode ms, upload ms (pageable copies, a synchronize at
    the end; medians of 3), the device decode's µs for the whole file
    (``_median_ms``), the host slabs, the slabs on the card)."""
    import torch

    from whisper_tpu_torch.frontend.golden import HOP
    from whisper_tpu_torch.frontend.mel import decode_transfer

    sf = int(session.cfg.mel_slab_frames)
    need = (sf + 2) * HOP
    encode, upload = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host = [session.encode_host_slab(padded, f0 * HOP, need)
                for f0 in range(0, n_valid, sf)]
        t1 = time.perf_counter()
        dev = [session._upload(h) for h in host]
        torch.cuda.synchronize()
        encode.append((t1 - t0) * 1e3)
        upload.append((time.perf_counter() - t1) * 1e3)
    tag = session._transfer_tag()
    decode_us = _median_ms(lambda: [decode_transfer(x, tag)
                                    for x in dev]) * 1e3
    return (sum(h.nbytes for h in host), statistics.median(encode),
            statistics.median(upload), decode_us, host, dev)


def check_wire(card: str, results, session, audio) -> None:
    """``[wire]``: the seven upload wires (``WIRES``) through the session
    of the main path (whisper-base x5), its ``audio_transfer`` set in turn.
    (a) The 301.574 s file through the graphed long-form path in each wire:
    bytes shipped, host encode ms, upload ms, device decode µs; the card's
    decode of every slab bitwise the port's decode of the same bytes on the
    CPU; a warm-up and three timed runs (tokens equal), the main path's
    kernels launched and B5 not; tokens against int16's: dint16 and dint16p
    bitwise, every divergence of f32, ulaw8, pcm12 and pcm14 a tie-flip by
    ``divergence_report`` on each wire's own mel.  (b) A 76 s clip one
    shot in each wire: the session's mel launches B5 once (wires other than
    float32 and int16 decoded ahead of it); B5's wrapper on the wire's
    bytes within 1e-4 of its plain version (or of its float64 evaluation
    where the plain version is farther), timed.  (c) One short-lane tick
    at bucket 16 (16 clips of 1-30 s, 128 tokens) under pcm12 and dint16:
    a key each, the graphed tick twice and an eager one bitwise, dint16's
    tokens int16's.  (d) The CLI under ``--audio-transfer auto`` and
    ``auto-pcm`` over the 4 s file: the probe's line, its rates and pick."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from whisper_tpu_torch.frontend import golden
    from whisper_tpu_torch.frontend.mel import decode_transfer
    from whisper_tpu_torch.ops import log_mel
    from whisper_tpu_torch.pipeline.chunk import chunk_starts, mel_frame_bucket

    t_phase = time.perf_counter()
    base_cfg = session.cfg
    by_name = {r["name"]: r for r in results}

    def wire(mode):
        session.cfg = dataclasses.replace(base_cfg, audio_transfer=mode)
        return session._transfer_tag()

    # (a) the 301.574 s file in each wire
    padded = golden.reflect_pad(audio).astype(np.float32)
    nv = golden.num_frames(len(audio))
    starts = [p // golden.HOP
              for p in chunk_starts(len(audio), 480_000, 400_000)]
    runs = {}
    for mode in WIRES:
        tag = wire(mode)
        n_bytes, enc_ms, up_ms, dec_us, host, dev = _wire_upload(
            session, padded, nv)
        same = all(torch.equal(decode_transfer(d, tag).cpu(),
                               decode_transfer(torch.from_numpy(h), tag))
                   for h, d in zip(host, dev))
        if not same:
            raise AssertionError(f"[wire] (a) {mode}: the card's decode is "
                                 "not the CPU's bitwise")
        e2e, timing, toks, counts = _timed_run(session, audio, results,
                                               runs=3)
        idle = [n for n in MAIN_PATH_KERNELS if counts[n] == 0]
        if idle or counts["log_mel"]:
            raise AssertionError(f"[wire] (a) {mode}: launches {counts}")
        mel = session.compute_mel(padded, nv, mel_frame_bucket(nv))
        runs[mode] = (toks, mel)
        print(f"[wire] (a) {mode}, whisper-base x5, {len(audio) / 16000} s "
              f"({len(host)} slabs), on {card}: {n_bytes:,} bytes shipped, "
              f"host encode {enc_ms:.2f} ms, upload {up_ms:.3f} ms, device "
              f"decode {dec_us:.1f} µs, the card's decode bitwise the CPU's;"
              f" e2e {e2e:.4f} s (preprocess {timing.preprocess_s:.4f} s; "
              f"median of 3), launches {counts}", flush=True)
    ref_toks, ref_mel = runs["int16"]
    for mode in WIRES:
        toks, mel = runs[mode]
        equal = float((toks == ref_toks).mean())
        if mode in LOSSLESS:
            if not (np.array_equal(toks, ref_toks)
                    and torch.equal(mel, ref_mel)):
                raise AssertionError(f"[wire] (a) {mode}: tokens or mel not "
                                     "int16's bitwise")
            line = "tokens and mel bitwise int16's"
        elif mode == "int16":
            continue
        else:
            verdict = _judge(session, session, ref_mel,
                             [(s0, PROMPT) for s0 in starts], ref_toks,
                             toks, EOT, f"{mode} against int16",
                             mel_var=mel)
            if verdict[4]:
                raise AssertionError(f"[wire] (a) {mode}: divergences that "
                                     f"are not tie-flips: {verdict[4]}")
            line = (f"mel within {float((mel - ref_mel).abs().max()):.4g} "
                    "of int16's; " + _judge_line(verdict))
        print(f"[wire] (a) {mode} against int16 on {card}: tokens equal "
              f"{equal:.4f} of {toks.size}; {line}", flush=True)

    # (b) B5 one shot on a 76 s clip in each wire
    clip = audio[:76 * 16000]
    cpad = golden.reflect_pad(clip).astype(np.float32)
    cnv = golden.num_frames(len(clip))
    bucket = mel_frame_bucket(cnv)
    b5_wires = by_name["log_mel"].setdefault("by_wire", {})
    for mode in WIRES:
        tag = wire(mode)
        _zero_counts(results)
        session.compute_mel(cpad, cnv, bucket)
        launches = _counts(results)["log_mel"]
        x = session._upload(session._encode_transfer(cpad))
        got = log_mel.log_mel(x, cnv, 80, bucket, transfer=tag)
        want = log_mel.log_mel_plain(x, cnv, 80, bucket, transfer=tag)
        exact = log_mel.log_mel_float64(x, cnv, 80, bucket, transfer=tag)
        err, err64, plain64 = (float((a - b).abs().max())
                               for a, b in ((got, want), (got, exact),
                                            (want, exact)))
        held = err if err <= 1e-4 or plain64 <= 1e-4 else err64
        if launches != 1 or held > 1e-4:
            raise AssertionError(f"[wire] (b) B5 {mode}: {launches} launches"
                                 f", {err:.3g} from the plain version "
                                 f"({err64:.3g} from float64)")
        ms = _median_ms(lambda: log_mel.log_mel(x, cnv, 80, bucket,
                                                transfer=tag))
        b5_wires[mode] = {"ms": ms, "launches": launches,
                         "max_abs_err": held, "bytes": x.nbytes}
        print(f"[wire] (b) B5, {mode}, 76 s one shot ({cnv} of {bucket} "
              f"frames, {x.nbytes:,} bytes) on {card}: {launches} launch in "
              f"the session's mel; the wrapper {ms:.4f} ms a call (decode "
              f"included), {err:.3g} from the plain version ({err64:.3g} "
              f"from float64; held {held:.3g} <= 1e-4)", flush=True)

    # (c) a short-lane tick at bucket 16 under pcm12 and dint16
    clips = _serve_clips(16, seed=28)
    rows = np.zeros((16, 480_400), dtype=np.float32)
    n_valid = np.zeros(16, dtype=np.int32)
    for i, c in enumerate(clips):
        p = golden.reflect_pad(c)
        rows[i, :len(p)] = p
        n_valid[i] = golden.num_frames(len(c))
    ticks = {}
    for mode in ("int16", "pcm12", "dint16"):
        wire(mode)
        keys = len(session.graphs.captures())
        first = session.transcribe_short_batch(rows, n_valid, PROMPT, 128,
                                               EOT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = session.transcribe_short_batch(rows, n_valid, PROMPT, 128,
                                               EOT)
        tick = time.perf_counter() - t0
        with _eager_loop(session):
            eager = session.transcribe_short_batch(rows, n_valid, PROMPT,
                                                   128, EOT)
        new = len(session.graphs.captures()) - keys
        if not (np.array_equal(first, eager) and np.array_equal(again, eager)
                and new == 1):
            raise AssertionError(f"[wire] (c) {mode}: graphed ticks bitwise "
                                 f"the eager one: {np.array_equal(first, eager)}"
                                 f", {np.array_equal(again, eager)}; {new} "
                                 "new keys")
        ticks[mode] = first
        if mode != "int16":
            print(f"[wire] (c) short lane, {mode}, bucket 16 (16 x 30 s "
                  f"rows), 128 tokens, on {card}: its own key; two graphed "
                  f"ticks bitwise the eager one; a tick {tick:.4f} s; "
                  f"tokens equal to int16's "
                  f"{float((first == ticks['int16']).mean()):.4f}", flush=True)
    if not np.array_equal(ticks["dint16"], ticks["int16"]):
        raise AssertionError("[wire] (c) dint16's tick is not int16's")
    session.cfg = base_cfg

    # (d) the CLI's probe
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = os.path.join(tmp, "audio")
        os.makedirs(audio_dir)
        name, secs, sr, ch = CLI_FILES[0]
        _write_wav(os.path.join(audio_dir, name), secs, sr, ch)
        os.environ["HF_HOME"] = os.path.join(tmp, "hf")
        for mode in ("auto", "auto-pcm"):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                run_cli(f"base-x5-{mode}", card, results, audio_dir, tmp,
                        ["--model-id", "openai/whisper-base",
                         "--max-new-tokens", "32", "--variant", "x5",
                         "--audio-transfer", mode])
            probe = [x for x in err.getvalue().splitlines()
                     if x.startswith("[wire-probe] ")]
            used = json.load(open(os.path.join(
                tmp, f"base-x5-{mode}", "s.json")))["config_used"]
            if len(probe) != 1 or not probe[0].endswith(
                    f"-> {used['audio_transfer']}"):
                raise AssertionError(f"[wire] (d) {mode}: probe {probe}, "
                                     f"ran {used['audio_transfer']}")
            print(f"[wire] (d) the CLI, --audio-transfer {mode}, on {card}: "
                  f"{probe[0]}; the run's audio_transfer "
                  f"{used['audio_transfer']}", flush=True)
    print(f"[wire] phase {time.perf_counter() - t_phase:.1f} s, on {card}",
          flush=True)


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--parallel-rank"]:     # a rank of [parallel] (b)
        rank, port, ref_path, out_path = sys.argv[2:6]
        return parallel_rank(int(rank), int(port), ref_path, out_path)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    from whisper_tpu_torch.headline import (
        AUDIO_SECONDS,
        MODEL_ID,
        card_info,
        make_session,
        synth_audio,
    )
    from whisper_tpu_torch.models.convert import init_params
    from whisper_tpu_torch.models.registry import get_dims
    from whisper_tpu_torch.ops import kernels
    from whisper_tpu_torch.pipeline.chunk import chunk_starts

    card = card_info()
    print(card, flush=True)

    t_start = t0 = time.perf_counter()
    phases, last = {}, [t_start]

    def done(phase: str) -> None:
        """The seconds since the last phase ended, as ``phase``'s."""
        now = time.perf_counter()
        phases[phase], last[0] = now - last[0], now

    lib = kernels.build(extra_flags=("-Xptxas", "-v"))
    print(f"[build] {lib.parent.name}: {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {kernels.build_seconds if kernels.build_seconds else 0:.1f}"
          " s, 0 = already built)", flush=True)
    log = lib.parent / "nvcc.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}", flush=True)
    pick_sass = check_sass(lib)
    done("build, SASS")

    results = check_kernels(card, pick_sass)
    done("kernels")

    dims = get_dims(MODEL_ID)
    params = init_params(dims, seed=0)
    check_against_cpu(params, dims)

    session = make_session("cuda", params)
    audio = synth_audio(AUDIO_SECONDS)
    # A warm-up, then three timed runs that must give equal tokens and
    # launch counts; the median run by e2e.
    x5_run = _timed_run(session, audio, results, runs=3)
    e2e, timing, toks, main_counts = x5_run
    main_c = _condition_count()          # the last run's: counts set to 0
    idle = [n for n in MAIN_PATH_KERNELS if main_counts[n] == 0]
    if idle or main_c == 0:
        raise AssertionError(f"kernels not launched on the main path: {idle}"
                             f", C launched {main_c} times")
    # the tail once a decode step, as B4 once a layer and step
    if main_counts["loop_tail"] * dims.decoder_layers \
            != main_counts["cross_attend_step"]:
        raise AssertionError(f"the tail launched {main_counts['loop_tail']} "
                             f"times, B4 {main_counts['cross_attend_step']}")
    n_chunks = len(chunk_starts(len(audio), 480_000, 400_000))  # 12
    if toks.shape != (n_chunks, 128):
        raise AssertionError(f"tokens {toks.shape}, expected "
                             f"({n_chunks}, 128)")
    if not ((toks >= 0) & (toks < dims.vocab_size)).all():
        raise AssertionError("token ids outside the vocabulary")
    check_main_path_finite(session, audio, dims)
    print(f"[main path] whisper-base x5, {AUDIO_SECONDS} s, on {card}: "
          f"e2e {e2e:.4f} s, preprocess {timing.preprocess_s:.4f} s, model "
          f"{timing.model_only_s:.4f} s, decode {timing.decode_s:.4f} s, "
          f"{AUDIO_SECONDS / e2e:.2f}x real time (median of 3); launches "
          f"per run {main_counts}, C {main_c} (ahead of each decode's while "
          f"node; the tail sets the condition after each step)", flush=True)
    done("the card against the CPU, the main path")
    check_wire(card, results, session, audio)
    done("[wire]")

    del session
    ladder_runs = check_ladder(card, results, params, dims, audio, x5_run)
    ladder = {label: r[3] for label, r in ladder_runs.items()}
    done("the ladder")
    spec, spec_tokens = check_speculative(card, results, params, dims, audio,
                                          x5_run)
    done("[speculative]")
    check_decoding(card, results, params, dims, audio, x5_run)
    done("[decoding]")
    check_prompts_words(card, results, params, dims, audio,
                        {"x7 against x5": (x5_run[2], ladder_runs["x7"][2]),
                         "speculative x5 against greedy x5":
                             spec_tokens["x5"],
                         "speculative x4 against greedy x4":
                             spec_tokens["x4"]})
    done("[prompts]")
    _memory_line("[serve]")
    check_serve(card, results, params, dims)
    done("[serve]")
    _memory_line("[pipelined]")
    check_pipelined(card, results, params, dims, audio)
    done("[pipelined]")
    _memory_line("[fused step]")
    fused_step, fused_ms = check_fused_step(card, results, params, dims,
                                            audio)
    done("[fused step]")
    _memory_line("[graph]")
    sampled, while_node = check_graph(card, results, params, dims, audio,
                                      x5_run, fused_ms)
    done("[graph] (a)-(d), (g)")
    _memory_line("[graph] (e), (f)")
    check_graph_beam_spec(card, results, params, dims, audio)
    done("[graph] (e), (f)")
    _memory_line("[exit]")
    check_exit(card, results, params, dims, audio)
    done("[exit]")
    _memory_line("[medium]")
    executor = concurrent.futures.ThreadPoolExecutor(1)
    try:
        drawn = _draw_family_weights(executor)
        medium = check_medium(card, results, drawn)
        done("[medium]")
        _memory_line("[large]")
        check_large(card, results, drawn)
        done("[large]")
    finally:
        executor.shutdown(cancel_futures=True)
    cli = check_cli(card, results)
    done("[cli]")
    check_audio(card, results)
    done("[audio]")
    check_parallel(card, results, params, dims, audio, x5_run,
                   ladder_runs["x7"][2])
    done("[parallel]")
    # Each kernel's launches in the run of its own path.  The two rows at
    # d = 1024 share their kernels' counters with the d = 512 rows: theirs
    # are whisper-medium's: B2c's from the CLI at whisper-medium x5, those
    # of B9a' from the 301.574 s file with the fused block ([medium] (b)).
    fused = ladder["x5+fused_encoder_block+fused_decoder_step"]
    path_of = {"log_mel": cli["whisper-base x5"]["log_mel"],
               "cross_attend_step_dequant":
                   cli["whisper-base int8"]["cross_attend_step_dequant"],
               "fused_encoder_mlp_d1024":
                   medium["cli medium x5"]["fused_encoder_mlp"],
               "self_attend_step_int8": ladder["x7"]["self_attend_step_int8"],
               "fused_ln_qkv": fused["fused_ln_qkv"],
               "fused_out_mlp": fused["fused_out_mlp"],
               "decoder_mlp_block": fused["decoder_mlp_block"],
               "fused_ln_qkv_d1024": medium["fused block"]["fused_ln_qkv"],
               "cross_attend_multi": spec["x5"]["cross_attend_multi"],
               "cross_attend_multi_dequant":
                   spec["x4"]["cross_attend_multi_dequant"],
               "decoder_self_block": fused_step["decoder_self_block"],
               "decoder_cross_block": fused_step["decoder_cross_block"],
               "gumbel_pick": sampled["gumbel_pick"],
               "while_condition": main_c}
    # the tail's and C's device µs alone, in flat graphs of 128 ([graph]
    # (g)); C has no wrapper of its own to time, so its ms is that
    by_name = {r["name"]: r for r in results}
    by_name["loop_tail"].update(device_us=while_node["tail_us"],
                                node_without_c_us=while_node[
                                    "node_without_c_us"])
    by_name["while_condition"].update(
        ms=while_node["c_us"] / 1e3, device_us=while_node["c_us"],
        in_body_us=while_node["c_in_body_us"],
        empty_device_us=while_node["empty_us"])
    for r in results:
        r["launches"] = path_of[r["name"]] if r["name"] in path_of \
            else main_counts[r["name"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']}: not launched on its path")
        del r["counter"]
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.0f} s, the "
          "kernels' build included; by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
