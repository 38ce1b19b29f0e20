#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card. It
fails (non-zero exit, no result line) when there is no card or the
package is not beside it, and when any phase fails:

1. the card's name and power limit (``nvidia-smi``);
2. building every CUDA kernel of the serving path from ``csrc/``;
3. each kernel against its plain PyTorch version on the card, in bf16,
   at both shapes the serving path gives it (Llama-3-8B attention: 32 q
   heads, 8 kv heads, head_dim 128, page 16; a mixed dispatch at qblock
   32 and a decode-only one at qblock 1), with its time, the plain
   version's time, a PyTorch library call's time and the card's bound;
   (phases 3 and 3d also print each kernel's device time from the
   profiler, which leaves out the host's time between launches, and for
   each fused call its write launch's device time alone beside the
   write's bound);
3d. the rest of the ragged paged attention family at phase 3's shapes
   and dispatches: the rope-fused call over int8 pools (#13), the
   post-rope fused call over bf16 and int8 pools (#11a, #11b) and the
   read-only call over pools written before (#10, #9); written int8
   slots and their scales bit for bit ``quantize_kv_int8`` in PyTorch on
   the card, written bf16 slots as phase 3, untouched slots and the dump
   page unchanged, outputs within phase 3's bound; each with the same
   four times (the library call: SDPA over the gathered K/V, dequantized
   to bf16 for int8); then every call form of the family at the
   reference's domain past phase 3's geometry (``DOMAIN``: pages of 64
   and 48 slots, f32 and f16 models, head_dim 256 and 72, int8 pools
   too), untimed, within phase 3's bound;
3f. #12 and #13 on 8 decode rows at Llama-3-8B's full context (contexts
   of 1-8192 tokens) at qblock 1 and 32, timed as phase 3 (where the
   tensor-core instance's split over the sequence shows); phases 3, 3d
   and 3f print the instance each launch ran (``attention_instance``);
3e. the decode paged attention kernel (#4, the ``PagedKVCache`` path)
   against its plain version: at phase 3's decode-only shape (8 rows,
   contexts 64-544, 32/8 heads, head_dim 128, page 16) over bf16 and f32
   pools, the bf16 pools also through #10's decode-only launch, and at
   Llama-3-8B's full context (32 bf16 rows over 1-8192 tokens, an
   inactive row among them); table tails poisoned; outputs within phase
   3's bound; the same four times (the library call: SDPA over the
   gathered K/V, kv heads repeated, with a length mask); then the
   reference's other operand forms (int64 tables and lens, bf16 q over
   f32 pools, f32 q over bf16 pools, raw int8 pools, a strided q) and a
   group of 512 query heads (H 1024, Hk 2, head_dim 256, f32), each in
   exactly one launch and no plain call, within the same bound, with the
   instance each ran;
3b. the training kernels against their plain versions on the card:
   flash attention forward, dQ and dK/dV at Llama-3-8B training shapes
   (batch 2 x seq 2048, 32 q / 8 kv heads, head_dim 128, bf16, causal;
   also a non-causal and a shorter-query causal case), and the fused
   linear cross-entropy forward at N = D = 4096, V = 128256, f32, 5% of
   rows ignored (the tensor-core instance, 3xTF32); each with its time
   (CUDA events and the profiler's device time), the plain version's, a
   PyTorch library call's and the card's bound (the loss: both, f32 on
   the CUDA cores and 3xTF32 on the tensor cores), and the instance each
   kernel ran (the wgmma instances at the training batch, with dQ's,
   dK/dV's and the loss's registers); then the loss and its gradients
   through the public function at bf16 hidden and weight (the same
   shape, timed too), at f32 hidden with a bf16 and with an f16 weight
   (the same shape: phase 19's O2 and GradScaler routes, the second
   under the scaler's 2^16) and at D =
   4100, f16 hidden and f32 weight (the general instance), against the
   plain path; then the flash kernels' general
   instance at ``FLASH_DOMAIN``'s points (f32 head_dim 128, bf16 96 and
   256, f16 64, and f16 128 at the training batch, phase 19b(ii)'s
   route); the registers and spills of every flash instance, of the
   ragged attention's tensor-core instance and of the dequant matmul's
   cluster instance (``ptxas -v``) are printed after the build;
4. serving Llama-3-8B at full width and depth (random bf16 weights from
   a seeded generator on the card) through
   ``LlamaServingEngine.generate``: 8 prompts of 64-512 tokens, 32 new
   tokens each, twice over one model: graphed (the default: decode
   scans whose ticks replay a CUDA graph, every tick mode's graph
   captured by ``prewarm``) and with ``decode_ticks=1`` (single mixed
   steps, the reference's way to take no scan), each with every launch
   of the kernels counted (2 a layer a dispatch or tick) and the plain
   attention never called, finite logits (read from the tick graph's own
   tensors after each replay); every token of the graphed run is checked
   against the model's own plain forward, the share equal to the
   single-step run's printed (rows retire at other ticks there, so it
   multiplies fewer rows than the padded tick), the graphed launches
   counted again by the profiler over a second run's scans, a window a
   scan, and held (the wrappers' counts of a replay are its capture's;
   the eager dispatches' wrappers count where they launch); no plain
   version called while the tick graphs are captured; tokens/s, TTFT,
   dispatch and tick times (host clock) of both runs;
4b. (run after 4) the tick graph against the same tick run eagerly: on a
   fresh engine with 8 live requests (greedy, biased and sampled rows),
   for each tick mode (greedy, bias only, sampled) one tick replayed
   from its graph, then from the same carry and pools the tick function
   called directly on the same static buffers: next tokens, lens and
   every pool slot (and scale) bit for bit equal; the launches of one
   replay counted by the profiler (a write and an attention a layer) and
   by the wrappers, its device time; the same for phase 8's int8 KV, for
   the three attention paths of phase 9 (greedy), and, at phase 7's cut,
   for the bf16 and the int8 Mixtral FFN (#6, then #7 and #8 under
   capture);
5. training at Llama-3-8B width cut to 8 layers (random f32 weights from
   a seeded generator on the card) through
   ``examples.llama_pretrain.train``: bf16 ``auto_cast``, AdamW, batch 2
   x seq 2048, 10 steps on one fixed seeded batch, every kernel launch
   counted (one of each flash kernel per layer per step, one loss kernel
   per step) and no plain version called, finite and falling losses;
   then one step of a 2-layer model with the kernels against the same
   step with the plain versions (loss and gradients), under bf16
   ``auto_cast`` and again in f32 (the flash kernels' general instance);
18. (run after 5b, 6 and 7) the pretraining recipe whole: (a) its entry point
   ``examples.llama_pretrain.main`` at phase 5's model and shapes for 10
   steps, the step compiled by ``jit.to_static`` into one CUDA graph
   after an eager warm-up at [1, 128], batches from the native
   ``TokenFeed`` over a seeded int32 corpus of 8 samples: the native
   feed served them, one capture, each replay launches 8 of each flash
   kernel and 1 loss kernel and the run one step's worth a call, no
   plain version, finite and falling losses; the graphed step's time,
   tokens/s, TFLOP/s and peak memory beside phase 5's eager step;
   (b) the 2-layer cut with AdamW, ``LinearWarmup(CosineAnnealingDecay)``
   and ``ClipGradByGlobalNorm(1.0)``, six compiled steps against six
   eager ones: every loss, parameter and optimizer tensor bitwise equal,
   the device learning rate after each replay ``float32(scheduler())``,
   one capture; (c) the seven other optimizers on the tiny config, 3
   compiled steps against 3 eager ones each, bitwise; (d) the recipe
   with ``--ckpt-dir`` at 1 layer (``CKPT_CUT``), again with
   ``--resume``, then ``CheckpointManager``'s async save during steps and
   ``restore_latest`` into a model built afresh: each restored state's
   digest equal to the saved one's (host memory and disk read first,
   short ones fail the phase), the snapshot, write, CRC and restore
   times printed;
19. (run after 18) training, the rest: (a) ``hapi.Model.fit`` over phase
   5's model under O2 (``amp.decorate``: bf16 parameters but the norms,
   f32 master weights and AdamW moments), the network returning the
   final hidden states and the loss the fused linear cross-entropy over
   the lm head, ``prepare(jit=True, amp_configs={"level": "O2"})``, a
   2-worker ``DataLoader`` shuffled by an int generator over a seeded
   int32 corpus, ``LRScheduler(by_step=True)`` (warm-up and cosine),
   ``History`` and ``MetricsCallback``, 10 steps, then ``evaluate`` on 2
   batches and ``predict`` on 1: one capture, each replay 8 / 8 / 8 / 1
   launches, no plain version, finite and falling losses, every
   non-norm parameter bf16 with an f32 master, ``train_steps_total`` the
   steps, ``train_mfu`` in (0, 1]; the step's time, tokens/s, TFLOP/s and
   peak memory beside 18a's O1 step; (b) at the 2-layer cut, one model
   on the card at a time: (i) O2 ``fit`` with ``jit=True`` against
   ``jit=False``, 4 steps bitwise (losses, parameters, masters,
   moments); (ii) float16 O2 under ``GradScaler(2**16)``, eager and
   compiled, a step forced to overflow: parameters bitwise, the scale
   halved, the moments unchanged (eager) or decayed by their betas
   (compiled, masked), later steps finite, the flash kernels' f16
   instance and the loss's f16 weight counted; (iii) one step each with
   recompute none / full / ``"dots"``: gradients within 1e-6 of none's,
   the activations held for the backward printed, "dots" between; (iv)
   ``scaled_dot_product_attention(dropout_p=0.1)`` at the model's
   attention shape: no flash launch, the keep share within 5 sigma of
   0.9, the mask bitwise the CPU plain version's for the key drawn,
   ``training=False`` launching the flash forward again; (c) at the
   tiny config: ``CheckpointCallback`` through ``fit`` and a restore,
   ``Model.save`` / ``load`` bitwise, ``evaluate``'s Accuracy (top 1 and
   5), Precision, Recall and Auc on the card equal to the same metrics on
   the CPU from the same outputs, ``EarlyStopping`` stopping at the CPU
   run's epoch;
20. (run after 19) mixture-of-experts training: (a) the recipe's entry
   point with ``--config 8b --layers 2 --moe 8 --moe-top-k 2 --amp
   --batch 1 --seq 2048 --steps 10`` (Llama-3-8B width with
   Mixtral-8x7B's expert shapes, 3.95 G parameters) over a seeded int32
   corpus, the step compiled into one CUDA graph after the eager warm-up:
   one capture, each replay launching a layer's flash kernels once each
   and the grouped GEMM (#6) three times forward and three times for dx,
   one loss kernel, no plain version, finite and falling losses; the
   step's time, tokens/s, peak memory, the grouped GEMM's instances and
   the weight gradients' (``grouped_gemm_dw``) share of the step; (b)
   one f32 step of the tiny config with ``--moe 4`` through the kernels
   against the plain versions: the loss and every gradient; (c)
   ``MoELayer`` at Mixtral width (D 4096, H 14336, E 8, gshard) on 2048
   tokens, forward and backward, ragged against dense, the dropped
   count equal, the ``moe_layer`` compile count 1 after two calls of one
   token count and 2 after another;
21. AMP debugging at the 2-layer cut of phase 5's model: the op table of
   one O1 forward (``collect_operator_stats``, the matmul family in
   bf16), the same forward's launches (the nodes of a CUDA graph
   captured from it) with the collection off as before the seam was
   first installed, the tensor checker raising
   on an Inf injected into layer 1's input and naming the op, a compiled
   step (``jit.to_static``, AdamW) under the checker bitwise the
   unchecked one and reading nothing in its capture and replays,
   ``check_numerics`` of a card tensor with 3 NaN and 2 Inf: ``(3, 2)``,
   the counter once, one flight-recorder dump;
22. weight quantization, the rest: (a) phase 9's cut (Llama-3-8B width, 4
   layers, bf16) served with int8 weights on phase 4's prompts,
   ``save_quantized``, ``load_quantized`` into a model built afresh and
   served again: every token bitwise, #8 and #12 counted, the
   checkpoint's bytes against bf16, the save and load seconds; (b) QAT,
   ``convert`` and ``bridge_model`` on a stack of ``torch.nn.Linear`` 4096
   -> 14336 -> 4096: the bridged weights bitwise the ``ConvertedLinear``'s
   dequantized ones, the forward through #8 within #8's bound of the
   plain forward; (c) ``fit_on_prompts`` (40 steps) and
   ``logits_quality`` of the tiny config, float against int8: the report
   printed, ``passes``;
23. (run after 22, before 17) distributed, in a child process of its own
   (so no NCCL state is left in this one for phase 17's profiler window;
   the child reports its launches back), in a NCCL world of one rank
   (over a ``FileStore`` in a temp dir, destroyed at the end of the
   phase, also when it fails): (a) every collective and p2p function of
   ``paddle_tpu_torch.distributed`` on card tensors, with the world of
   one's results (the reference's eager identities, zeros where p2p
   receives nothing), ``send`` raising; the layers' own collectives (the
   Megatron regions, which run NCCL on a group of one too) equal to the
   identity, and the layers' NCCL all-reduce captured into a CUDA graph
   and replayed right on new data, the graph's nodes printed (NCCL
   enqueues no kernel for a communicator of one rank); (b) the recipe's ``--mesh 1x1`` at
   phase 5's model cut to 2 layers, 3 steps, the step compiled into one
   CUDA graph with its collectives: one capture, each replay launching a
   layer's flash kernels once each and the loss kernel once on the
   vocab shard, no plain version, the losses within 1e-4 of the same
   seed's one-device recipe, both printed; (c) ``--mesh 1x1 --moe 8
   --ep`` at 1 layer, 2 steps: the same holds with the grouped GEMM (#6)
   six times a replay; each run's step time and peak memory;
3c. (run after 3b) the mixture-of-experts and int8 kernels against their
   plain versions at Mixtral-8x7B serving shapes (hidden 4096, expert
   FFN 14336, 8 experts, top 2, block 128) for the two token counts of
   the serving run (8, a decode-only dispatch; 64, a full mixed one):
   the dequant matmul (q/o N = 4096, k/v N = 1024), the int8 and the
   bf16 grouped GEMMs (gate/up and down shapes, routed by
   ``top_k_routing``, plus an empty expert and group sizes past the
   stride), the grouped GEMM's dx through its backward, each timed by
   CUDA events and by the profiler's device time beside the library
   call's two times; the dequant matmul's rows 0, 5 and 37 alone and
   among 7 and 63 others, bitwise equal, at both N; then tokens through a
   Mixtral-width ``LlamaMoEMLP`` alone and packed among 7 and among 63
   others, bitwise equal, float and int8; the instance each grouped GEMM
   launch ran (both kernels' cluster instances at 16-bit x, their
   registers and spills printed); then the three kernels at
   ``GEMM_DOMAIN``'s points of the reference's domain (f16 x, blocks of
   8, 24 and 40, N 24, K and N off multiples of 8), each on the instance
   ``gemm_instance`` names (the general one but for the f16 points of
   the grouped GEMMs, which their cluster instances take), two f16
   points and a B = 24 point timed as the Mixtral shapes are (with bound
   and library time);
6. serving Mixtral-8x7B at full width and depth with int8 weights (built
   layer by layer from a seeded generator on the card, each layer
   quantized as it is made: 93 GB of bf16 never exist at once) through
   ``LlamaServingEngine(weight_dtype="int8")``: phase 4's prompts,
   graphed and with ``decode_ticks=1`` as phase 4, every launch counted
   (per dispatch or tick: the attention kernel's two launches, four
   dequant matmuls and three int8 grouped GEMMs per layer), no plain
   version called, every token of the graphed run checked against the
   model's own forward through the plain versions of all kernels, the
   experts it chose replayed (recorded from its dispatches and from the
   tick graph's routing tensors after each replay); a second graphed
   run's launches counted by the profiler as phase 4's and held;
7. the same for the bf16 MoE FFN at 4 layers (32 need two cards) with
   ``weight_dtype=None``: three float grouped GEMMs per layer;
8. (run after 4) Llama-3-8B at full width and depth with int8 KV pages,
   ``LlamaServingEngine(kv_dtype="int8")``, phase 4's prompts: every
   launch of #13 counted (2 a layer a dispatch), no plain version
   called, the KV pool's bytes beside phase 4's, every served token
   checked against the model's own plain forward with K and V through
   ``quantize_kv_int8`` and back (phase 4's floors), and the share of
   tokens equal to phase 4's printed; graphed and single steps as phase
   4, and phase 4b on int8 pools;
9. (run after 8) the engine's three attention paths at Llama-3-8B width
   cut to 4 layers, both KV dtypes, phase 4's prompts: rope-fused (#12 /
   #13), ``fused_rope=False`` (#11a / #11b) and ``fused_kv=False`` (the
   PyTorch scatter, then #10 / #9), each with ``decode_ticks=1`` and
   graphed: identical greedy tokens; with single steps pools, sidecars
   and attention outputs bitwise equal after the first (mixed) dispatch;
   pools after the whole run, both ways; launches counted per path (2 a
   layer a dispatch or tick fused, 1 two-op), no plain version called;
9b. (run after 9) the engine at Llama-3-8B width cut to 4 layers,
   phase 4's prompts, at 64-slot pages (bf16) and as an f32 model, and
   cut to 2 layers as an f16 model with ``weight_dtype="int8"`` (the
   dequant matmul on f16 x): every #12 and dequant launch counted, no
   plain version called, tokens held against the plain forward (with the
   plain dequant matmul) at phase 4's floors, graphed and single steps
   as phase 4;
10. (run after 9b) ``PagedKVCache`` at Llama-3-8B attention width on the
   card (12288 pages of 16 tokens, bf16): 32 sequences admitted with
   seeded prompts of 1-8160 tokens and their K/V written, 32 decode
   steps of ``extend`` + ``write`` + ``attend``, then half of them
   released and 16 new ones admitted on the recycled pages, 8 more
   steps; one #4 launch per ``attend`` and no plain version called; the
   first and last step of each stretch held against the plain version on
   the same pools within phase 3's bound; every launch on the
   tensor-core instance; mean ``attend`` time (host clock,
   synchronised), device time, the host's share, pool bytes and peak
   memory;
3g. (run after 3c) the sampler's Gumbel pass (``gumbel_argmax`` and
   ``gumbel_noise``) against its plain version at 8 and 64 rows of
   Llama-3's (128256) and Mixtral's (32000) vocabularies, greedy, top-k,
   top-p and constrained rows mixed, their scores and thresholds from the
   sampler's own plain steps: bits and uniforms bit for bit, ``g`` within
   ``GUMBEL_REL`` of max(|g|, 1), tokens equal but where the plain
   version's top two perturbed scores lie within that tolerance (each such
   row printed with its margin); the kernel's time (CUDA events and the
   profiler's device time), the plain version's, the sampler's sort's and
   the bound (the larger of the scores' bytes and ``GUMBEL_INT_OPS``
   32-bit integer operations an element at the integer pipe's rate);
11. (run after 4) phase 4's model and prompts with sampled rows: 2
   greedy, 2 at temperature 0.8 / top_p 0.9, 2 at temperature 1.0 /
   top_k 50, 1 with a ``logit_bias`` forcing a token and 1 with a
   constraint hook; the greedy rows bitwise phase 4's tokens, a second
   run with the same seeds identical, the forced and constrained rows
   obeying their rules, the sampled tokens replayed through the model's
   plain forward and the plain sampler at the same (seed, position) at
   phase 4's share floor (the margins of the rows that differ printed),
   exactly one ``gumbel_argmax`` launch and one sort per dispatch that
   holds a sampled row, no plain version called (all with
   ``decode_ticks=1``: the constraint pins the engine to single steps);
   then graphed with the constrained row made greedy: the sampled tick
   graph replayed, one launch a sampled dispatch or tick, the greedy
   rows bitwise phase 4's graphed tokens, the forced row obeying, the
   sampled rows replayed through the plain forward and sampler at the
   same floor;
   tokens/s beside phase 4's (phase 4 itself, all greedy, sorts nothing);
12. (run after 11) ``LlamaForCausalLM.generate`` at Llama-3-8B's full
   width and depth over its static KV cache: 4 prompts of 128 tokens, 32
   new tokens, greedy (tokens held against the plain forward at phase 4's
   floors, and their share equal to the engine's greedy tokens printed)
   and ``do_sample`` (top_k 50, top_p 0.9, fixed seed: one
   ``gumbel_argmax`` launch a step, no plain version called), each step
   after the prefill a replay of the step's CUDA graph, its tokens bit
   for bit the same loop's run eagerly (same batch and buffer), the time
   per step of both, and one replay's launches and device time;
13. (run after 10) shared-prefix serving: Llama-3-8B at full width cut
   to 16 layers (``PREFIX_LAYERS``), bf16, behind
   ``LlamaServingEngine(max_batch=8, page_size=16, num_pages=400)``,
   graphed; one seeded 512-token prefix (32 pages) and
   8 prompts of it plus seeded suffixes of 16-128 tokens, 32 new tokens
   each, greedy; request 0 by ``add_request`` (cold: its pages are
   pinned when its prefill ends), then the other 7, then decoding to the
   end; twice on one model, with the prefix cache (the engine's default)
   and without. Held exactly over the phase's requests: 8 lookups, 7
   hits, 3584 saved prefill tokens; 1088 prompt tokens dispatched with
   the cache against 4672 without; the 32 shared pages' K/V in every
   layer bit for bit unchanged from the end of request 0's prefill to
   the end of the run; free plus cached pages the usable pages at the
   end, no table left. Every token of both runs at phase 4's floors
   against the plain forward; the share equal between the runs printed;
   per-request TTFT, mixed dispatches and their time, tokens/s and peak
   pages in use of both runs. Then the copy-on-write check: a sequence
   admitted on the cached pages made to write into a shared one, so the
   engine's ``_copy_page`` runs: the new page bit for bit the old in
   every layer, every pool at its address, and after a replayed tick
   wrote the new page the old one unchanged;
13b. phase 13 with ``kv_dtype="int8"`` (67,584 bytes a token): the same,
   the scale sidecars of the shared pages and of the copy included, the
   plain forward's K and V through the int8 quantizer;
13c. phase 13's traffic with the cache at Llama-3-8B width cut to 4
   layers through the three attention paths (rope-fused #12 / #13,
   ``fused_rope=False`` #11a / #11b, ``fused_kv=False`` #10 / #9), both
   KV dtypes, graphed: phase 13's holds on each path, and the warm
   requests' tokens, the pools and the sidecars bit for bit equal across
   the paths;
14a. (run after 13b) the degradation ladder under decode pressure: phase
   13's model, graphed, on 152 pages (151 usable); a completed 256-token
   request leaves 15 pages in the cache; then 8 seeded prompts of 256
   tokens (128 pages), 128 new tokens each, priorities 0, 0, 1, 1, 2, 2,
   3, 3, retry budget 1 but 0 for the second: the cache gives its pages
   back before any live request is evicted, then the ladder evicts by
   (priority, tokens emitted), requeues and re-admits; the evictions,
   re-admissions, statuses and output lengths held equal to the CPU
   schedule's (``PRESSURE_EVENTS``, ``PRESSURE_END``), the evicted
   requests' typed ``AdmissionError``, the completed requests' tokens at
   phase 4's floors, the allocator consistent, launches counted (one
   tick replay's by the profiler too, as phase 4b), no plain version
   called;
14b. retirement, on a pool that holds everything with
   ``admit_retries=2``: 8 of phase 4's prompts admitted; a 9th admission
   shed as "engine full" after two backoffs with a ``retry_after``; one
   request with a 1 ms deadline expired at the next boundary; one
   cancelled from its own ``on_token`` at its 8th token; one cancelled
   from a second thread while a graphed scan is in flight (its release
   deferred past the scan), and a fresh request admitted on the pages it
   released; statuses and lengths held equal to the CPU schedule's
   (``LIFECYCLE_END``; the deadline's and the thread-cancel's by status
   alone), tokens at the floors, the allocator consistent, launches as
   14a;
14c. (run after 14a) the host KV tier: phase 14a's model, pool and traffic
   with ``kv_tier=True``, the tier's cap ``PAUSE_TIER_PAGES`` pages of
   Llama-3-8B's bf16 KV: the pauses, the pause the tier cannot hold
   (evicted instead), the resume and the re-admission in order, and the
   statuses and lengths held equal to the CPU schedule's
   (``PAUSE_EVENTS``, ``PAUSE_END``), tokens at the floors, no paused copy
   left in the tier, the allocator consistent, launches counted, no plain
   version called; printed: each export's device-to-host copy and CRC ms,
   each restore's ms (staged or not), the tier's peak bytes, tokens/s and
   prompt tokens re-prefilled beside 14a's. Then, on the same geometry, a
   lone request paused at its ``PAUSE_AT``-th token and resumed unstaged,
   and again staged (a tick graph captured while it stages), and paused
   from a second thread inside a graphed scan: tokens bitwise its
   uninterrupted run's, restored pages bitwise the exported ones, every
   pool at its address; then phase 13's prompt served cold and warm, its
   cached pages demoted into the tier and promoted back by the same
   prompt: every page promoted, tokens bitwise the warm run's;
14d. (run after 13c) phase 13c's 4-layer cut through the three attention
   paths, both KV dtypes, graphed, the tier on: 14c's lone and in-flight
   pauses (restored pages and int8 sidecars bitwise, pools in place,
   tokens bitwise), the tokens, pools and sidecars bitwise across the
   paths; then the reference test's copy-chaos plan on its tight pool
   (``CHAOS_PLAN``, ``CHAOS_GEOM``): every request completed or failed
   typed, the tier's counts ``CHAOS_STATS`` (the CPU's), nothing leaked;
15. (run after 14b) speculative decoding: phase 13's model (Llama-3-8B at
   full width, 16 layers, bf16), ``max_batch=8``, page 16, phase 4's pool;
   8 prompts of 64-512 tokens, each a seeded 16-token block repeated (the
   prompt-lookup traffic the n-gram drafter exists for), 32 new tokens
   each, greedy; four runs: no speculation graphed, no speculation with
   ``decode_ticks=1``, ``spec_k=4`` with the n-gram drafter, ``spec_k=4``
   with an oracle drafter that proposes the single-step run's tokens,
   then its own last pass's tokens until 90% of its drafts are accepted
   (at most 6 passes: on random weights the card's rounding at another
   GEMM M flips near-ties, after which a request's first proposals are
   stale). Each: every #12 launch counted (2 a layer a dispatch or tick: a verify
   row is a multi-token decode row of the same call), no plain version
   called and nothing sorted, the drafts scheduled equal to
   ``spec_stats()``'s proposed count and accepted at most proposed, the
   allocator consistent (no double free, no table left), every token at
   phase 4's floors against the model's own plain forward; printed:
   dispatches, verify dispatches and rows, tokens per verify row,
   acceptance, mixed dispatch ms, tokens/s and the share of tokens equal
   to the single-step run's;
15b. phase 11's graphed rows (greedy, temperature / top-p, temperature /
   top-k, a forcing bias) over phase 4's prompts and model with
   ``spec_k=4``, an oracle drafter proposing a non-speculative run's
   tokens at the same seeds and the n-gram drafter: phase 15's holds,
   one ``gumbel_argmax`` launch and one sort per dispatch that holds a
   sampled row, over every packed token (``[T, V]``) on a chunk-shaped
   dispatch, the forced row obeying, the sampled tokens replayed through
   the plain forward and sampler at the same (seed, position) at phase
   4's floor;
15c. (run after 13c) phase 13c's 4-layer cut through the three attention
   paths, both KV dtypes, ``spec_k=3`` with a garbage drafter (every
   draft the model does not emit rejected, its verify row rolled back)
   over phase 15's prompts: phase 15's holds on each path, and tokens,
   pools, sidecars and ``spec_stats()`` bit for bit equal across the
   paths;
16. (run after 15b) observability: phase 13's model (Llama-3-8B at full
   width, 16 layers, bf16) and traffic (8 prompts of a 512-token prefix
   plus 16-128-token suffixes, 32 new each, graphed) through a fresh
   engine with metrics on, the host tier on, and no warm-up of the
   smoke's own: the engine warms each cold dispatch shape itself. Held:
   admitted 8, completed 8, generated 256; the prefill-token, prefix
   lookup, hit and saved counters equal to the engine's own records and
   to the CPU schedule's (1088 prompt tokens, 8 lookups, 7 hits, 3584
   saved); ``serving_ttft_seconds``'s count 8 and
   ``serving_token_latency_seconds``'s the decode tokens of warm
   dispatches and scans; ``serving.mixed_step`` / ``serving.decode_scan``
   spans one a dispatch and a scan, a ``serving.first_token`` span under
   each request's trace; a warm-up of both shapes (#12's write launch)
   leaving every page bitwise (the trash page put back) and a paused
   request's host copy CRC-equal; the same traffic on an engine built under
   ``PADDLE_TPU_METRICS=0`` bitwise the same tokens with an empty
   registry, no span and no warm-up; a raise forced inside ``step``
   leaving one loadable post-mortem whose ``env.json`` names
   ``serving.step`` and holds ``memory_stats``; a stalled dispatch under
   the engine's watchdog counting one ``watchdog_timeouts_total``; a
   restarted engine's ``prewarm()`` with no arguments warming the
   recorded shapes. Printed: tokens/s of a second pass with metrics on and
   off (host clock, synchronised), the host ms a dispatch the metrics
   add, and the builds, loads, cache hits and captures the compile
   watcher saw over the whole run;
17. (run after 7, before 4c, on phase 13's model built again from its
   seed: its in-process profiler window opens on a server thread, after
   every phase that counts profiler records) the serving stack over the
   engine, its own seconds printed:
17a. in process: a ``ServingCluster`` of two ``EngineReplica``s sharing
   the model (each ``max_batch=8``, page 16, phase 13's pool, the prefix
   cache on, prewarmed: every tick mode's graph captured; 16 decode ticks
   a worker-loop tick), ``FileStore`` membership (TTL 30 s) in a temp
   dir, behind a ``ServingFrontend`` on ``127.0.0.1:0`` with a
   ``QosGate`` of a premium tenant and a batch tenant whose bucket starts
   drained. Over HTTP: phase 13's 8 prompts (32 new tokens, greedy, one
   streamed over SSE), one sampled request (temperature 0.8, top-p 0.9,
   a seed) and 4 low-tenant requests; the replica that does not hold the
   stream is killed once one of its requests is 2 tokens in. Held: every
   request answered 200 and every flood request 429 with a
   ``Retry-After``; the stream's chunks are its 32 tokens and end in
   ``[DONE]``; every greedy token at phase 4's floors against the model's
   plain forward; #12 launched 2 a layer an eager forward or a tick
   replay (a capture's own pass excluded), no plain version called,
   ``gumbel_argmax`` once a sampled forward or tick;
   ``router_failovers_total`` the requests failed over (each completed),
   one ``replica_deaths_total``, one replacement and no other death, the
   prefix hits the engines' own, the tenants' admitted and shed counts
   the traffic's; a second wave of 4 requests under
   ``/debug/profile?seconds=1`` whose bundle's profiler started and holds
   attention kernel records; ``/readyz`` 503 while both replicas drain.
   Printed beside the card: tokens/s, TTFT, the failover's added
   latency, the card's memory at the peak;
17b. subprocesses: a ``ServingCluster`` of two ``SubprocessReplica``s
   (``python -m paddle_tpu_torch.inference.replica_worker``), each
   building Llama-3-8B from seed 0 in bf16 on the card (its weights'
   digest in its log equal to the parent's model's), rpc over the native
   ``TCPStore``, ``FileStore`` membership, their kernel build
   directory (the compile cache) empty at the first spawn; phase 13's
   traffic with the worker of the first request 2 tokens in SIGKILLed.
   Held: every request completed, every token at phase 4's floors
   against the parent's model; the first starts built the kernels
   (cache misses), the replacement found them built (hits, no miss) and
   its ``restart_ttft`` is below the victim's first; the merged scrape
   holds both workers
   (``paddle_tpu_xla_compile_total`` for
   ``kernel:ragged_paged_attention`` under each ``replica``);
   ``capture_profile(1.0)`` under a second wave (64 new tokens a
   request, after a window of none in every process, which initialises
   CUPTI) returns the router's and both workers' shards, each worker's
   with CUDA records. Printed: cold and warm ``restart_ttft``, tokens/s,
   each process's card memory, each window's profiler start latency;
4c. (run last) a capture that fails (a host read under capture) raises,
   leaves the current stream as it was, and the next capture replays
   right; no phase catches a capture's error, so one ends the run;

then a JSON line of kernel results and the final result line.
"""

import contextlib
import dataclasses
import faulthandler
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

H, HK, D, PAGE, QB = 32, 8, 128, 16, 32     # Llama-3-8B serving shapes
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM device memory
BF16_FLOPS = 989e12                          # H100 SXM dense bf16
OUT_VEC = 2 ** -10  # out slack beyond 1 ulp, x the head vector's max
# gradient rows can cancel to f32 rounding noise (the first causal query:
# one key, P = 1, dP - delta = 0); that noise scales with the terms, so a
# gradient's head-vector max is taken at least GRAD_FLOOR x the tensor max
GRAD_FLOOR = 2 ** -6
NEW = 32            # new tokens per served request
EXACT_FLOOR = 0.75  # share of served tokens equal to the plain argmax
TIE_TOL = 0.5       # logit gap allowed to the plain forward's argmax
RPA_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
# the ragged paged attention family: launch-count key -> (JSON name, line
# of the TPU kernel's pallas_call in paddle_tpu/ops/ragged_paged_attention
# .py, rope inside the call, int8 pools, read-only)
VARIANTS = {
    "fused_rope": ("fused_ragged_paged_attention_rope", 1060, True, False,
                   False),                                        # 12
    "fused_rope_q8": ("fused_ragged_paged_attention_rope_q8", 1133, True,
                      True, False),                               # 13
    "fused": ("fused_ragged_paged_attention", 921, False, False, False),
    "fused_q8": ("fused_ragged_paged_attention_q8", 990, False, True,
                 False),                                          # 11b
    "ragged": ("ragged_paged_attention", 368, False, False, True),  # 10
    "ragged_q8": ("ragged_paged_attention_q8", 328, False, True, True),
}
F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 on the tensor cores
TRAIN_B, TRAIN_S = 2, 2048               # Llama-3-8B training batch
TRAIN_LAYERS, TRAIN_STEPS = 8, 10        # depth cut to fit one card
CE_N, CE_D, CE_V = 4096, 4096, 128256    # the loss at those shapes
CE_IGNORED = 0.05   # share of loss rows at ignore_index
CE_GENERAL = (512, 4100, 32000)   # N, D, V of the general instance's point
LSE_ABS = 1e-3      # flash lse tolerance
CE_REL = 1e-4       # loss kernel lse/pick, relative to max(|x|, 1)
LOSS_REL = 1e-5     # loss through the kernel vs through the plain version
GRAD_REL = 1e-4     # CE grads vs the plain path, x the grad's max
STEP_LOSS_REL = 1e-2   # whole-model step, kernels vs plain versions
GRAD_COS, GRAD_NORM = 0.999, 0.01
FA_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FA_REPLACES = {"forward": "paddle_tpu/ops/flash_attention.py:155",
               "dq": "paddle_tpu/ops/flash_attention.py:279",
               "dkv": "paddle_tpu/ops/flash_attention.py:299"}
FA_NAMES = {"forward": "flash_attention_forward",
            "dq": "flash_attention_backward_dq",
            "dkv": "flash_attention_backward_dkv"}
# Mixtral-8x7B-v0.1 (Jiang et al., arXiv 2401.04088): the published
# config of mistralai/Mixtral-8x7B-v0.1, its eleven numbers as they are
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=32768,
               rms_norm_eps=1e-5, rope_theta=1e6, moe_num_experts=8,
               moe_top_k=2)
MOE_TOKENS = (8, 64)     # decode-only and full mixed dispatch, max_batch 8
WEIGHT_BLOCK = 128       # the int8 format's default block
FLOAT_MOE_LAYERS = 4     # bf16 Mixtral: 4 layers fit one card, 32 do not
LADDER_LAYERS = 4        # phase 9: Llama-3-8B width cut to 4 layers
# phase 3d: #13, #11a, #11b, #10, #9 (keys of VARIANTS)
FAMILY = ("fused_rope_q8", "fused", "fused_q8", "ragged", "ragged_q8")
# layer 0: an engine route may sit this far below the plain router's
# k-th logit (random router logits have std ~1.3; rounding moves them
# by ~0.01)
ROUTE_TOL = 0.1
GG_SOURCE = "paddle_tpu_torch/csrc/grouped_gemm.cu"
PA_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
PA_REPLACES = "paddle_tpu/ops/paged_attention.py:153"
FULL_CTX = 8192          # Llama-3-8B's context (max_position_embeddings)
# phase 10: one PagedKVCache on the card (12288 pages of 16 tokens, bf16:
# 768 MiB of pools), 32 sequences, then half of them replaced
CACHE_PAGES, CACHE_ROWS, CACHE_PROMPT = 12288, 32, 8160
CACHE_STEPS, CACHE_REFILL_STEPS = 32, 8
# the sampler (phases 3g, 11, 12): no Pallas kernel; the line of the
# reference's Gumbel-max argmax it replaces
SM_SOURCE = "paddle_tpu_torch/csrc/sampling.cu"
SM_REPLACES = "paddle_tpu/inference/sampling.py:234"
SAMPLER_VOCABS = {"llama3": 128256, "mixtral": 32000}
SAMPLER_ROWS = (8, 64)
# 32-bit integer operations an element: 20 threefry rounds of add, rotate
# and xor, 5 key injections, the 64-bit counter and the uniform's shift/or
GUMBEL_INT_OPS = 85
# the integer pipe: 64 lanes an SM against the 128 f32 lanes whose FMAs
# (2 operations) make F32_FLOPS, so a quarter of that rate
INT32_OPS = F32_FLOPS / 4
SAMPLED_ROWS = (None, None, dict(temperature=0.8, top_p=0.9),
                dict(temperature=0.8, top_p=0.9),
                dict(temperature=1.0, top_k=50), dict(temperature=1.0,
                                                      top_k=50),
                "forced", "constrained")
FORCED_TOKEN = 1234
ALLOWED = (11, 22, 33, 44, 55, 66, 77, 88)
GEN_PROMPTS, GEN_LEN, GEN_NEW = 4, 128, 32


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
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
    end.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler keeps only the device records whose CUPTI timestamps
# fall inside its window on the host's clock, and the two clocks were up
# to 254 us apart on the H100 (tools/torch_profiler_drops.py: a kernel
# put before its own launch). Records of kernels near an edge of a tight
# window were left out: 41 of 6000 spin kernels over 300 windows, two
# windows empty, and none over 600 windows paused 20 ms at each edge.
PROFILE_PAD_S = 0.02


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` window over the card, paused
    ``PROFILE_PAD_S`` on the host after it opens and again after the
    card is idle, before it closes, so no record of its kernels falls
    outside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_events(prof):
    """The device records (kernels and copies) of a closed window."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms_by_kernel(fn, iters=20):
    """Mean device time per call of each kernel (and copy) ``fn``
    launches, ``{name: ms}``, from ``torch.profiler``: unlike
    :func:`time_ms` it leaves out the host's time between launches,
    which is longer than the kernels' at small shapes.

    The profiler can leave out a call's records even in a padded window
    (one call of five, in one H100 run the launches of all three of its
    names), so a name's time is the mean of its records times its
    launches a call, the whole number nearest its records over
    ``iters`` (at least one). A window that lacks records of some call
    is measured again once and the fuller one is kept; the names left
    short are printed beside the reading. An empty window twice fails:
    never an empty sum."""
    import collections
    import torch
    fn()
    torch.cuda.synchronize()
    best = None
    for attempt in range(2):
        with profiled() as prof:
            for _ in range(iters):
                fn()
        dur, seen = collections.Counter(), collections.Counter()
        for e in device_events(prof):
            dur[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            seen[e.name] += 1
        if best is None or sum(seen.values()) > sum(best[1].values()):
            best = (dur, seen)
        short = {k[:60]: n for k, n in seen.items() if n % iters}
        if seen and not short:
            break
        print(f"device_ms: the profiler recorded "
              f"{short if seen else 'no record'} over {iters} calls"
              + ("; measuring again" if not attempt else ""), flush=True)
    dur, seen = best
    if not seen:
        fail(f"device_ms: the profiler recorded no device record over "
             f"{iters} calls twice; no device time to report")
    return collections.Counter(
        {k: dur[k] / n * max(1, round(n / iters)) for k, n in seen.items()})


def device_ms(fn, iters=20):
    """Mean device time of the kernels ``fn`` launches, per call
    (:func:`device_ms_by_kernel`, summed)."""
    return sum(device_ms_by_kernel(fn, iters).values())


def attention_batch(dev, qb, ctx, chunks, inactive, seed=0, page=PAGE,
                    d=D, dtype="bfloat16"):
    """One dispatch at serving shapes (pages of ``page`` slots, head_dim
    ``d``, model dtype ``dtype``): 8 decode rows with contexts drawn
    from ``range(*ctx)``, then the ``chunks`` of one prompt as rows of
    the same dispatch, then (if ``inactive``) an inactive row; table
    tails past the live pages are poisoned with out-of-range ids.
    Returns (args, info)."""
    import numpy as np
    import torch
    PAGE, D = page, d   # phase 3's names, at this geometry
    rng = np.random.RandomState(seed)
    dec = rng.randint(*ctx, size=8)
    seqs = [(int(n) - 1, [1]) for n in dec] + ([(0, chunks)] if chunks
                                                else [])
    n_pages = [-(-(p + sum(c)) // PAGE) for p, c in seqs]
    num_pages = sum(n_pages) + 17               # 16 untouched + dump
    dump = num_pages - 1
    perm = rng.permutation(num_pages - 1)
    width = max(n_pages) + 3
    rows, used, t = [], 0, 0
    for (prior, chs), npg in zip(seqs, n_pages):
        pages = perm[used:used + npg]
        used += npg
        start = prior
        for c in chs:
            rows.append((pages, start + c, start, c, prior, t,
                         prior + sum(chs)))
            start += c
        t += sum(chs)
    if inactive:
        rows.append(((), 0, 0, 0, 0, 0, 0))
    tables = np.empty((len(rows), width), np.int32)
    for i, row in enumerate(rows):
        tables[i] = rng.choice([-5, 10 ** 7, num_pages + 11], width)
        tables[i, :len(row[0])] = row[0]
    meta = np.asarray([r[1:] for r in rows], np.int32).T
    pos = np.concatenate([np.arange(s, s + n)
                          for _, _, s, n, *_ in rows if n > 0])
    g = torch.Generator(dev).manual_seed(seed)
    bf = dict(device=dev, dtype=getattr(torch, dtype), generator=g)
    from paddle_tpu_torch.ops.ragged_paged_attention import rope_tables
    sin, cos = rope_tables(torch.from_numpy(pos).to(dev), D, 500000.0)
    i32 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (tables, *meta)]
    args = dict(q=torch.randn(t, H, D, **bf),
                new_k=torch.randn(t, HK, D, **bf),
                new_v=torch.randn(t, HK, D, **bf),
                k_pages=torch.randn(num_pages, HK, PAGE, D, **bf),
                v_pages=torch.randn(num_pages, HK, PAGE, D, **bf),
                block_tables=i32[0], kv_lens=i32[1], q_starts=i32[2],
                q_lens=i32[3], w_starts=i32[4], w_flats=i32[5],
                w_ends=i32[6], dump_page=dump, rope_sin=sin, rope_cos=cos,
                qblock=qb)
    written = np.zeros((num_pages, PAGE), bool)
    pairs = 0                                   # unmasked (query, key)
    for pages, kv, qs, ql, *_ in rows:
        for p in range(qs, qs + ql):
            written[pages[p // PAGE], p % PAGE] = True
            pairs += p + 1
    info = dict(rows=len(rows), tokens=t, num_pages=num_pages, dump=dump,
                written=torch.from_numpy(written).to(dev), pairs=pairs,
                prior_tokens=sum(p for p, _ in seqs))
    return args, info


def bound(args, info, variant="fused_rope"):
    """Least time the card could take for one call of ``variant``: every
    input byte read once and every output byte written once over the
    memory rate, or the attention's operations over the bf16 rate; the
    larger wins. Pools are bf16, or int8 with one f32 scale per (token,
    kv head); the read-only calls read the whole context from the pools,
    the others read the fresh K/V from ``new_k``/``new_v`` and write
    them (quantized where the pools are int8)."""
    _, _, rope, q8, read_only = VARIANTS[variant]
    t = info["tokens"]
    el = 2                                      # bf16 bytes
    slot = HK * (D * (1 if q8 else el) + (4 if q8 else 0))   # a pool token
    kv_read = info["prior_tokens"] + (t if read_only else 0)
    # q: the valid query rows only, whatever its layout (a row-blocked
    # q's padding is never read)
    q_rows = int(args["q_lens"].sum())
    nbytes = (2 * kv_read * slot                         # live K/V read
              + q_rows * H * D * el                      # q
              + sum(args[k].numel() * 4 for k in (
                  "block_tables", "kv_lens", "q_starts", "q_lens",
                  "w_starts", "w_flats", "w_ends") if k in args)
              + info["rows"] * info["qblock"] * H * D * el)  # out
    if not read_only:
        nbytes += 2 * t * HK * D * el + 2 * t * slot     # fresh in, written
    if rope:
        nbytes += 2 * t * D * 4                          # sin/cos
    ops = 4 * D * H * info["pairs"]              # QK^T and PV
    return roofline(nbytes, ops, BF16_FLOPS)


def write_bound(args, info, variant):
    """Least time the card could take for the write launch of one call
    of the fused ``variant``: the fresh K/V read once, their slots (and
    int8 scales) written once, the rows' metadata and, with rope, K's
    sin/cos rows read once, over the memory rate."""
    _, _, rope, q8, _ = VARIANTS[variant]
    t, d = info["tokens"], args["new_k"].shape[-1]
    el = args["new_k"].element_size()
    slot = HK * (d * (1 if q8 else el) + (4 if q8 else 0))
    nbytes = 2 * t * HK * d * el + 2 * t * slot \
        + 5 * info["rows"] * 4 + (2 * t * d * 4 if rope else 0)
    return roofline(nbytes, 0, BF16_FLOPS)


def ulp_bf16(x):
    """The bf16 spacing at each element of ``x`` (0 at 0)."""
    import torch
    x = x.float()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def check_close(label, got, ref, floor=0.0):
    """Each element of ``got`` within 1 bf16 ulp of ``ref`` plus OUT_VEC
    of its head vector's (last axis) largest value, that largest value
    taken at least ``floor`` x the tensor's largest; returns the largest
    absolute difference."""
    import torch
    ref, got = ref.float(), got.float()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite values")
    diff = (got - ref).abs()
    vec_max = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        floor * float(ref.abs().max()))
    over = diff - (ulp_bf16(ref) + OUT_VEC * vec_max)
    if bool((over > 0).any()):
        idx = tuple(int(x) for x in (over > 0).nonzero()[0])
        fail(f"{label}: differs at {idx}: {float(got[idx])} vs "
             f"{float(ref[idx])}")
    return float(diff.max())


def variant_args(args, variant, q8_pools):
    """The keyword arguments of one call of ``variant`` on phase 3's
    dispatch ``args`` (packed pre-rope q and fresh K/V, bf16 pools):
    fresh copies of the pools, or of their int8 twins ``q8_pools`` and
    sidecars; q gathered into ``[R, qblock]`` row blocks where the call
    takes it post-rope; the write operands dropped for the read-only
    call."""
    import torch
    _, _, rope, q8, read_only = VARIANTS[variant]
    a = dict(args)
    if q8:
        kq, vq, ks, vs = (x.clone() for x in q8_pools)
        a.update(k_pages=kq, v_pages=vq, k_scale=ks, v_scale=vs)
    else:
        a.update(k_pages=a["k_pages"].clone(), v_pages=a["v_pages"].clone())
    if not rope:
        qb = a.pop("qblock")
        del a["rope_sin"], a["rope_cos"]
        q = torch.zeros((a["block_tables"].shape[0], qb)
                        + tuple(a["q"].shape[1:]), dtype=a["q"].dtype,
                        device=a["q"].device)
        meta = [a[k].tolist() for k in ("q_starts", "q_lens", "w_starts",
                                        "w_flats")]
        for i, (qs, ql, ws, wf) in enumerate(zip(*meta)):
            q[i, :ql] = a["q"][wf + qs - ws:wf + qs - ws + ql]
        a["q"] = q
    if read_only:
        for k in ("new_k", "new_v", "w_starts", "w_flats", "w_ends",
                  "dump_page"):
            del a[k]
    return a


def check_kernel(dev, label, qb, ctx, chunks, inactive,
                 variant="fused_rope", geom=None):
    """Phases 3 and 3d: one instance of the ragged paged attention family
    against its plain version on one dispatch; returns its numbers.
    With ``geom`` (``attention_batch``'s page, d, dtype) the dispatch
    takes that geometry and the check runs untimed.
    Written int8 slots and their scales, V slots and unroped K slots must
    equal the plain version's bit for bit (the plain int8 write is
    ``quantize_kv_int8`` in PyTorch on the card), roped bf16 K slots lie
    within 1 ulp, and no other slot (the dump page included) changes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    _, _, rope, q8, read_only = VARIANTS[variant]
    args, info = attention_batch(dev, qb, ctx, chunks, inactive,
                                 **(geom or {}))
    info["qblock"] = qb
    q8_pools = None
    if q8:
        kq, ks = quantize_kv_int8(args["k_pages"])
        vq, vs = quantize_kv_int8(args["v_pages"])
        q8_pools = (kq, vq, ks[..., None], vs[..., None])
    fn, plain = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_ref) \
        if read_only else (rpa.fused_ragged_paged_attention,
                           rpa.fused_ragged_paged_attention_ref)
    orig = variant_args(args, variant, q8_pools)
    a_k = variant_args(args, variant, q8_pools)
    a_r = variant_args(args, variant, q8_pools)
    before = dict(rpa.instance_launches)
    out_k = fn(**a_k)
    ran = [k.split(".", 1)[1] for k, n in rpa.instance_launches.items()
           if n > before[k]]
    if len(ran) != 1:
        fail(f"{label} {variant}: instances {ran}, not one launch")
    out_r = plain(**a_r)
    torch.cuda.synchronize()
    # zeros (padding, inactive rows) must be exact: their bound is 0
    err = check_close(f"{label}: kernel out (row, query, head, col)",
                      out_k, out_r)
    ref = out_r.float()
    rel = float(((out_k.float() - ref).abs() / ref.abs().amax(
        dim=-1, keepdim=True).clamp_min(1e-30)).max())
    written = info["written"][:, None, :]               # [P, 1, page]
    pools = ("k_pages", "v_pages") + (("k_scale", "v_scale") if q8 else ())
    k_bits = True
    for name in pools:
        wr = written.expand(a_k[name].shape[:3])
        if not torch.equal(a_k[name][~wr], orig[name][~wr]):
            fail(f"{label}: the kernel changed {name} slots no row writes")
        if read_only:
            continue
        got, want = a_k[name][wr], a_r[name][wr]
        if name == "k_pages" and rope and not q8:
            got, want = got.float(), want.float()
            if not bool(((got - want).abs() <= ulp_bf16(want)).all()):
                fail(f"{label}: written K slots differ from the plain "
                     "version by > 1 ulp")
            k_bits = torch.equal(got, want)
        elif not torch.equal(got, want):
            fail(f"{label}: written {name} slots differ from the plain "
                 "version")
    if geom:
        return dict(max_abs_err=err, rel=rel, instance=ran[0])
    # timing: a fused call rewrites the same slots each time (idempotent)
    ms = time_ms(lambda: fn(**a_k))
    by_kernel = device_ms_by_kernel(lambda: fn(**a_k))
    dev_ms = sum(by_kernel.values())
    write_ms = sum(v for k, v in by_kernel.items() if "kv_write" in k)
    plain_ms = time_ms(lambda: plain(**a_r), iters=5, warmup=1)
    # library yardstick: SDPA over the gathered pages (dequantized to
    # bf16 from int8) with the same mask; the port never calls it
    tables = args["block_tables"].long().clamp(0, info["num_pages"] - 1)
    r = tables.shape[0]
    group = H // HK

    def gathered(pool, sc):
        x = pool[tables]
        if sc is not None:
            x = (x.float() * sc[tables]).to(torch.bfloat16)
        x = x.transpose(2, 3).reshape(r, -1, HK, D)
        return x.repeat_interleave(group, dim=2).transpose(1, 2)
    kg = gathered(a_k["k_pages"], a_k.get("k_scale"))
    vg = gathered(a_k["v_pages"], a_k.get("v_scale"))
    qr = variant_args(args, "fused", None)["q"].transpose(1, 2)
    kpos = torch.arange(kg.shape[2], device=dev)
    qpos = args["q_starts"].long()[:, None] + torch.arange(qb, device=dev)
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < args["kv_lens"].long()[:, None, None]) \
        & (torch.arange(qb, device=dev)[None, :, None]
           < args["q_lens"].long()[:, None, None])
    mask = mask[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qr, kg, vg, attn_mask=mask))
    bound_ms, bound_by = bound(a_k, info, variant)
    write = "" if read_only else (
        f" write_device_ms={write_ms:.4f} write_bound_ms="
        f"{write_bound(a_k, info, variant)[0]:.5f} (bytes) "
        f"attention_device_ms={dev_ms - write_ms:.4f}")
    print(f"kernel check ({VARIANTS[variant][0]}, {label}): "
          f"instance={ran[0]} qblock={qb} "
          f"rows={info['rows']} tokens={info['tokens']} "
          f"pages={info['num_pages']} out_err={err:.3e} (max err / "
          f"head-vector max {rel:.3e}; tol 1 ulp + {OUT_VEC} x head-vector "
          f"max) written_K_bitwise={bool(k_bits) and not read_only} "
          f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by}){write}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_kernels(dev, variants=("fused_rope",)):
    """Phases 3 and 3d at both shapes the serving path launches the
    family with: a mixed dispatch (qblock = chunk_block) and a
    decode-only one (qblock 1, contexts of the served requests). Returns
    each instance's JSON entry (without ``launches``) with the mixed
    dispatch's times, in the order of ``variants``."""
    entries = []
    for variant in variants:
        mixed = check_kernel(dev, "mixed", QB, (100, 2001), [QB, QB], True,
                             variant)
        decode = check_kernel(dev, "decode", 1, (64, 545), [], False,
                              variant)
        name, line = VARIANTS[variant][:2]
        entries.append(dict(
            name=name, route="cuda", source=RPA_SOURCE,
            replaces=f"paddle_tpu/ops/ragged_paged_attention.py:{line}",
            **dict(mixed, max_abs_err=max(mixed["max_abs_err"],
                                          decode["max_abs_err"]))))
    return entries


# phase 3f: decode rows at Llama-3-8B's full context, where one long row set
# the time before the split over the sequence
LONG_CTX = (1, FULL_CTX + 1)


def check_long_context(dev):
    """Phase 3f: #12 and #13 (bf16 and int8 pools) on 8 decode rows with
    contexts drawn from 1-8192, at qblock 1 and 32 (the decode-only and
    mixed dispatch widths), timed as phase 3 with its bound. Returns
    {variant: max abs err}."""
    errs = {}
    for qb in (1, QB):
        for variant in ("fused_rope", "fused_rope_q8"):
            r = check_kernel(dev, f"long context qblock {qb}", qb, LONG_CTX,
                             [], False, variant)
            errs[variant] = max(errs.get(variant, 0.0), r["max_abs_err"])
    return errs


# phase 3d: the reference's domain past phase 3's geometry, each point
# through all six call forms of the family at the mixed dispatch
DOMAIN = {"page 64": dict(page=64), "f32": dict(dtype="float32"),
          "head_dim 256": dict(d=256), "head_dim 72": dict(d=72),
          "f16 page 48": dict(page=48, dtype="float16")}


def check_kernel_domain(dev):
    """Phase 3d's widened points: every instance of the family against
    its plain version at pages of 64 and 48 slots, f32 and f16 models,
    head_dim 256 and 72 (int8 pools too), within phase 3's bound, with
    the instance's launches counted. Returns {variant: max abs err}."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    errs = {}
    for label, geom in DOMAIN.items():
        line = []
        for variant in VARIANTS:
            before = rpa.launches[variant]
            r = check_kernel(dev, label, QB, (100, 2001), [QB, QB], True,
                             variant, geom)
            if rpa.launches[variant] == before:
                fail(f"{label} {variant}: no kernel launch counted")
            errs[variant] = max(errs.get(variant, 0.0), r["max_abs_err"])
            line.append(f"{variant}={r['max_abs_err']:.3e} "
                        f"({r['instance']})")
        print(f"kernel check (domain, {label}: {geom}): out_err "
              + " ".join(line), flush=True)
    return errs


def llama_model(dev, layers=None, dtype="bfloat16"):
    """Llama-3-8B at full width (``layers`` cut, else full depth) with
    random weights in ``dtype`` from a seeded generator on the card."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    cfg = llama3_8b_config()
    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=dev, dtype=getattr(torch, dtype),
                             generator=gen).eval()
    torch.cuda.synchronize()
    print(f"model: llama3_8b layers={cfg.num_hidden_layers} {dtype} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    return cfg, model


def serving_engine(model, kv_dtype=None, page_size=16, weight_dtype=None,
                   decode_ticks=None, prefix_cache=False, **kw):
    """``LlamaServingEngine(max_batch=8)`` over ``model``: by default
    decode scans whose ticks replay CUDA graphs; ``decode_ticks=1`` takes
    single mixed steps only, as the reference does with it. The prefix
    cache (the engine's default) is off unless asked for: with it on every
    finished prompt pins its full pages, which changes the pool state the
    phases before 13 measure (and their numbers' meaning against earlier
    runs), and a second run of the same prompts on one engine would hit;
    phases 13 and 14 drive it."""
    from paddle_tpu_torch.inference import LlamaServingEngine
    return LlamaServingEngine(model, max_batch=8, page_size=page_size,
                              kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                              decode_ticks=decode_ticks,
                              prefix_cache=prefix_cache, **kw)


def warm_up(engine, prompts):
    """``engine.prewarm`` of its two dispatch shapes and, unless it takes
    single steps only, its scans (every tick mode's graph captured), then
    one short request, 2 new tokens (a prefill and a scan of 4 ticks).
    The tick graphs are captured here: a plain version captured into one
    would run at every replay with no Python call, so one called here
    fails the phase (:func:`captured_kernels_only`)."""
    scans = [engine.decode_ticks] if engine.decode_ticks > 1 else []
    with captured_kernels_only("warm-up"):
        engine.prewarm([engine.chunk_budget, engine.max_batch], scans)
        engine.generate([prompts[0][:16]], max_new_tokens=2)


@contextlib.contextmanager
def captured_kernels_only(label):
    """Fail if a plain version of the serving path or of the sampler is
    called in the context (where tick graphs are captured)."""
    from paddle_tpu_torch.ops import sampling as SM
    with count_calls(serving_plain_versions()
                     + [(SM, "gumbel_argmax_ref")]) as plain_calls:
        yield
    if plain_calls:
        fail(f"{label}: plain versions ran on the card (and into a tick "
             f"graph if captured): {sorted(set(plain_calls))}")


def serving_workload(dev, kv_dtype=None, layers=None, page_size=16,
                     dtype="bfloat16", weight_dtype=None, decode_ticks=None):
    """Llama-3-8B at full width (and depth, unless ``layers``; random
    weights in ``dtype`` from a seeded generator on the card) behind
    :func:`serving_engine`, warmed up, and 8 prompts of 64-512 tokens.
    Returns (cfg, model, engine, prompts)."""
    cfg, model = llama_model(dev, layers, dtype)
    engine = serving_engine(model, kv_dtype, page_size, weight_dtype,
                            decode_ticks)
    prompts = serving_prompts(cfg.vocab_size)
    warm_up(engine, prompts)
    return cfg, model, engine, prompts


def serving_prompts(vocab):
    """The serving workload: 8 seeded prompts of 64, 128, ..., 512
    tokens."""
    import numpy as np
    rng = np.random.RandomState(0)
    lens = np.linspace(64, 512, 8).astype(int)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def reset_launches():
    """Set every kernel's launch count to 0 (every counter is registered
    in ``ops._build.COUNTERS``)."""
    from paddle_tpu_torch.ops import _build
    for counts in _build.COUNTERS:
        for key in counts:
            counts[key] = 0


def serving_plain_versions():
    """The serving path's plain versions, as ``count_calls`` targets."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    return [(rpa, "fused_ragged_paged_attention_ref"),
            (rpa, "ragged_paged_attention_ref"),
            (GG, "grouped_gemm_ref"), (GG, "grouped_gemm_q8_ref"),
            (QK, "dequant_matmul_ref")]


def kv8_attention(q, k, v):
    """The no-cache forward's attention as the int8-KV engine computes
    it: K and V through ``quantize_kv_int8`` and back (``int8 * scale``
    per token and kv head), f32 scores, softmax and product."""
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    from paddle_tpu_torch.models import llama
    (kq, ks), (vq, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
    kd, vd = kq.float() * ks[..., None], vq.float() * vs[..., None]
    return llama.plain_attention(q.float(), kd, vd).to(q.dtype)


# ----------------------------------------------------------------------
# CUDA-graph decode: taps, launches per replay, the tick replay check
# ----------------------------------------------------------------------

class TickTaps:
    """What :func:`tick_taps` records: ``records``, one ``(rows,
    {tag: [tensor, ...]})`` per mixed dispatch and per tick (a
    dispatch's rows ``(req, start, n)``; a tick's rows one token each at
    its position), in the order they ran."""

    def __init__(self):
        self.records = []
        self.captured = {}        # tick mode -> [(tag, tensor)] of a capture
        self.mode = None          # the tick mode running or being captured
        self.pending = None       # the tags of the dispatch or tick running
        self.scan = None          # the scan's (live, starts)
        self.tick = 0

    def tap(self, tag, t):
        """Called by a forward hook with a tensor the forward computed."""
        import torch
        if torch.cuda.is_current_stream_capturing():
            self.captured.setdefault(self.mode, []).append((tag, t))
        elif self.pending is not None:
            self.pending.setdefault(tag, []).append(t)
        # else: a capture's warm-up tick on the padding rows


@contextlib.contextmanager
def tick_taps(engine):
    """Record every mixed dispatch of ``engine`` and every tick it runs
    (:class:`TickTaps`). A forward hook runs when a tick graph is
    captured, not when it is replayed: a tensor tapped during a capture
    is the graph's own, rewritten by each replay, so it is cloned after
    every replay (no host read). Enter before the engine captures."""
    taps = TickTaps()
    names = ("_dispatch_rows", "_tick", "_load_scan", "_run_tick")
    dispatch, tick, load, run = (getattr(engine, n) for n in names)

    def on_dispatch(rows, cow=()):
        taps.pending = {}
        try:
            return dispatch(rows, cow)
        finally:
            taps.records.append(([(r, start, n) for r, _, start, n, _, _
                                  in rows], taps.pending))
            taps.pending = None

    def on_tick(mode):
        taps.mode = mode
        try:
            return tick(mode)
        finally:
            taps.mode = None

    def on_load(live, starts, mode, *snapshot):
        taps.scan, taps.tick = (list(live), list(starts)), 0
        return load(live, starts, mode, *snapshot)

    def on_run(mode):
        live, starts = taps.scan
        rows = [(r, s + taps.tick, 1) for r, s in zip(live, starts)]
        taps.tick += 1
        if not engine._graphs.cuda:        # the CPU runs the tick itself
            taps.pending = {}
            out = run(mode)
            taps.records.append((rows, taps.pending))
            taps.pending = None
            return out
        out = run(mode)
        tags = {}
        for tag, t in taps.captured.get(mode, ()):
            tags.setdefault(tag, []).append(t.clone())
        taps.records.append((rows, tags))
        return out
    with instance_attrs(engine, **dict(zip(names, (
            on_dispatch, on_tick, on_load, on_run)))):
        yield taps


@contextlib.contextmanager
def finite_taps(model, taps):
    """Tap whether each forward's lm head logits are all finite."""
    import torch
    hook = model.lm_head.register_forward_hook(
        lambda mod, inp, out: taps.tap("finite", torch.isfinite(out).all()))
    try:
        yield
    finally:
        hook.remove()


def all_finite(records):
    return all(bool(f) for _, tags in records for f in tags.get("finite", ()))


# kernel families counted by the profiler: a fragment of the kernel's name
# -> the family; a ragged family call launches a write and an attention
KERNEL_FRAGMENTS = {"kv_write_kernel": "write", "attention_tc": "attention",
                    "ragged_attention_kernel": "attention",
                    "gumbel_argmax_kernel": "gumbel",
                    "dq_cluster_kernel": "dequant",
                    "dequant_matmul::": "dequant",
                    "q8_cluster_kernel": "grouped",
                    "float_cluster_kernel": "grouped",
                    "grouped_gemm::": "grouped"}


def profiled_launches(fn):
    """Run ``fn`` under ``torch.profiler`` (:func:`profiled`) and count
    the device launches of the port's kernels by family
    (``KERNEL_FRAGMENTS``), graph replays' kernels included. Returns
    (fn's result, ``{family: n}``, the device time of all its kernels
    and copies in ms). Callers hold the counts against the wrappers'
    (:func:`hold_profiled`)."""
    import collections
    with profiled() as prof:
        out = fn()
    counts = collections.Counter()
    busy = 0.0
    for e in device_events(prof):
        busy += e.time_range.end - e.time_range.start
        fam = next((f for k, f in KERNEL_FRAGMENTS.items() if k in e.name),
                   None)
        if fam:
            counts[fam] += 1
    return out, dict(counts), busy / 1e3


@contextlib.contextmanager
def profiled_scans(engine):
    """Profile each decode scan of ``engine`` in a ``torch.profiler``
    window of its own; yields ``(prof, py)``, the launches of the port's
    kernels by family summed over the scans, by the profiler and by the
    wrappers (:func:`python_launches`). A replay's wrapper counts are its
    capture's, so the profiler's are the ones that show what the card
    ran. The mixed dispatches are eager: their wrappers count where they
    launch, so only the scans are windowed (each window is paused at its
    edges, :func:`profiled`; the run that holds them is not timed)."""
    import collections
    prof, py = collections.Counter(), collections.Counter()
    scan = engine._decode_scan

    def windowed(n):
        py0 = python_launches()
        out, c, _ = profiled_launches(lambda: scan(n))
        prof.update(c)
        py.update({k: v - py0[k] for k, v in python_launches().items()})
        return out
    with instance_attrs(engine, _decode_scan=windowed):
        yield prof, py


def hold_profiled(label, prof, py):
    """Fail unless the profiler's launches ``prof`` (by family) are the
    wrappers' ``py`` (:func:`python_launches` over the same run): a
    ragged family call launches a write and an attention."""
    if prof.get("write", 0) + prof.get("attention", 0) \
            != py.get("ragged", 0) or not prof.get("attention"):
        fail(f"{label}: profiler {prof} against the wrappers' {py}")
    for fam in ("gumbel", "dequant", "grouped"):
        if prof.get(fam, 0) != py.get(fam, 0):
            fail(f"{label}: {fam} launches, profiler {prof} against the "
                 f"wrappers' {py}")


def python_launches():
    """The wrappers' launch counts of the serving path by family (a fused
    call counts its write and attention launches)."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import sampling as SM
    from paddle_tpu_torch.quant import kernels as QK
    return {"ragged": sum(rpa.launches.values()),
            "gumbel": SM.launches["gumbel_argmax"],
            "dequant": QK.launches, "grouped": sum(GG.launches.values())}


def tick_state(engine):
    """Everything a tick writes: the scan's carry, its out buffer and
    tick counter, the pools and the scale sidecars."""
    g = engine._graphs.buffers
    return [g[k] for k in ("tokens", "lens", "out", "tick")] \
        + engine.k_pools + engine.v_pools + engine.k_scales + engine.v_scales


# phase 4b: the tick modes and the sampling of each request of the check
TICK_MODES = ("greedy", "bias", "sampled")


def tick_requests(prompts):
    """8 requests over the first 48 tokens of ``prompts``: 4 greedy, 1
    with a logit bias, 3 sampled (each tick mode finds its rows)."""
    from paddle_tpu_torch.inference import Request, SamplingParams
    sps = [None] * 4 + [SamplingParams(logit_bias={FORCED_TOKEN: 3.0})] + [
        SamplingParams(temperature=0.8, top_p=0.9, seed=2000 + i)
        for i in range(3)]
    return [Request(p[:48], max_new_tokens=NEW, sampling=sp)
            for p, sp in zip(prompts, sps)]


def check_tick_replay(engine, label, prompts, modes=("greedy",)):
    """Phase 4b on ``engine`` (fresh, warmed or not): admit and prefill
    :func:`tick_requests`, then for each tick mode take one tick both
    ways from the same state: its CUDA graph replayed (its launches
    counted by the profiler and by the wrappers), then, with the carry
    and pools restored, the tick function called directly on the same
    static buffers. Next tokens, lens and every pool slot and scale must
    be bit for bit equal (same shapes). Returns the profiler's launches
    per replay of each mode."""
    import torch
    for r in tick_requests(prompts):
        engine.add_request(r)
    live = [r for r in engine._live.values() if not r.done]
    per_replay = {}
    for mode in modes:
        with captured_kernels_only(f"tick replay {label} {mode} capture"):
            engine._ensure_tick(mode)
        starts = [engine.alloc.extend(r.seq_id, 1) for r in live]
        engine._load_scan(live, starts, mode, *engine._scan_rows(live))
        state = tick_state(engine)
        before = [t.clone() for t in state]
        py0 = python_launches()
        _, prof, dev_ms = profiled_launches(
            lambda: engine._run_tick(mode))
        py = {k: v - py0[k] for k, v in python_launches().items() if v != py0[k]}
        replayed = [t.clone() for t in state]
        for t, b in zip(state, before):
            t.copy_(b)
        engine._tick(mode)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(replayed, state)]
        per_replay[mode] = prof
        print(f"tick replay {label} {mode}: replay == eager tick bitwise "
              f"over {len(same)} tensors (tokens, lens, out, tick, pools"
              f"{', scales' if engine.kv_quant else ''}) {all(same)}; "
              f"launches per replay, profiler {prof}, wrappers {py}; "
              f"device_ms per replay {dev_ms:.3f}",
              flush=True)
        if not all(same):
            fail(f"tick replay {label} {mode}: the replayed tick differs "
                 f"from the eager tick in tensors "
                 f"{[i for i, x in enumerate(same) if not x]}")
        hold_profiled(f"tick replay {label} {mode}", prof, py)
    return per_replay


@contextlib.contextmanager
def instance_attrs(obj, **attrs):
    """Set attributes on ``obj`` for the context, then put back what was
    there (an instance attribute, or none)."""
    had = {n: obj.__dict__[n] for n in attrs if n in obj.__dict__}
    for n, v in attrs.items():
        setattr(obj, n, v)
    try:
        yield
    finally:
        for n in attrs:
            if n in had:
                setattr(obj, n, had[n])
            else:
                delattr(obj, n)


@contextlib.contextmanager
def timed_dispatches(engine):
    """Time each of ``engine``'s mixed dispatches and scans on the host
    clock (each ends in its read-back, so synchronised) and count its
    ticks by mode; yields ``{"mixed": [s], "decode": [s], "scan": [(s,
    ticks)], "ticks": {mode: n}}``."""
    import collections
    times = collections.defaultdict(list)
    times["ticks"] = collections.Counter()
    dispatch, scan, run = (engine._dispatch_rows, engine._decode_scan,
                           engine._run_tick)

    def counted_tick(mode):
        times["ticks"][mode] += 1
        return run(mode)

    def timed_dispatch(rows, cow=()):
        t0 = time.perf_counter()
        out = dispatch(rows, cow)
        mixed = any(n > 1 or not dec for _, _, _, n, _, dec in rows)
        times["mixed" if mixed else "decode"].append(time.perf_counter()
                                                     - t0)
        return out

    def timed_scan(n):
        t0 = time.perf_counter()
        out = scan(n)
        times["scan"].append((time.perf_counter() - t0, n))
        return out
    with instance_attrs(engine, _dispatch_rows=timed_dispatch,
                        _decode_scan=timed_scan, _run_tick=counted_tick):
        yield times


def served_run(engine, prompts, label, key, layers, taps):
    """One timed run of phase 4's requests through ``engine.generate``,
    every launch counted and no plain version called: returns (reqs,
    outs, wall, launches, mixed dispatches, ticks, times, the dequant
    matmul's launches)."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    n0 = len(taps.records)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with count_calls(serving_plain_versions()
                     + [(torch, "sort")]) as plain_calls, \
            timed_dispatches(engine) as times:
        reset_launches()
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
        dq_launches = dict(QK.instance_launches)
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    if "sort" in plain_calls:
        fail(f"{label}: an all-greedy run sorted "
             f"{plain_calls.count('sort')} times")
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    want = {k: 0 for k in launches}
    want[key] = 2 * layers * (mixed + ticks)
    if launches != want or not mixed:
        fail(f"{label}: kernel launches {launches} != {want} (2 x layers x "
             f"(dispatches + ticks) of {key})")
    per = layers * (mixed + ticks)
    n_dq = sum(dq_launches.values())
    if n_dq % per:
        fail(f"{label}: dequant matmul launches {dq_launches} for {per} "
             "layer dispatches")
    if not all_finite(taps.records[n0:]):
        fail(f"{label}: non-finite logits in the serving run")
    for o in outs:
        if len(o) != NEW or not all(0 <= t < engine.model.config.vocab_size
                                    for t in o):
            fail(f"{label}: bad output {o}")
    return reqs, outs, wall, launches[key], mixed, ticks, times, dq_launches


def run_line(reqs, wall, mixed, ticks, times):
    """tokens/s, TTFT and the host-clock dispatch and tick times of one
    run, as printed."""
    ttft = sorted(r.ttft for r in reqs)
    n_tok = sum(len(r.output_ids) for r in reqs)
    scans = times.get("scan", [])
    tick_s = sum(s for s, _ in scans) / max(sum(n for _, n in scans), 1)
    mean = {k: 1e3 * sum(times.get(k, ())) / max(len(times.get(k, ())), 1)
            for k in ("mixed", "decode")}
    return (f"dispatches={mixed} ticks={ticks} (scans={len(scans)}) "
            f"wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f} "
            f"ttft_ms_p50={1e3 * ttft[len(ttft) // 2]:.1f} ttft_ms_max="
            f"{1e3 * ttft[-1]:.1f} mixed_dispatch_ms="
            f"{mean.get('mixed', 0):.2f} decode_dispatch_ms="
            f"{mean.get('decode', 0):.2f} (n={len(times.get('decode', []))})"
            f" tick_ms={1e3 * tick_s:.2f}")


def serve(dev, kv_dtype=None, bf16=None, label=None, tick_check=False,
          **workload):
    """Phase 4 (``kv_dtype=None``) and phase 8 (``"int8"``): serve
    Llama-3-8B at full depth through the engine's entry point, twice over
    one model: the default engine (decode scans, each tick a replayed CUDA
    graph) and one with ``decode_ticks=1`` (single mixed steps, the
    reference's way to take no scan). Each: every launch of the
    rope-fused attention (#12, or #13 on int8 pools) counted (2 a layer a
    dispatch or tick) and no plain version called, finite logits (read
    from the tick graphs' own tensors after each replay). The graphed
    run's tokens are held against the model's own plain forward (its K
    and V through the int8 quantizer and back for phase 8) at the floors;
    its replays' launches are counted by the profiler too, over a second
    graphed run's scans; the share of its tokens equal to the single-step
    run's is printed (rows retire at other ticks there, so the eager run
    multiplies fewer rows than the padded tick and cuBLAS may round
    another way). ``workload`` (layers, page_size, dtype, weight_dtype)
    shapes the model and engines (phase 9b); with int8 weights every
    projection launches the dequant matmul and the plain forward takes
    its plain version too. ``tick_check``: phase 4b on a third engine.
    All rows are greedy, so nothing is sorted. ``bf16``: phase 4's
    result, for phase 8's share of equal tokens. Returns a dict:
    launches, outs, single_outs, tps, single_tps."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.models import llama
    label = label or ("serve int8-kv" if kv_dtype else "serve")
    key = "fused_rope_q8" if kv_dtype else "fused_rope"
    cfg, model = llama_model(dev, workload.get("layers"),
                             workload.get("dtype", "bfloat16"))
    layers = cfg.num_hidden_layers
    prompts = serving_prompts(cfg.vocab_size)
    kw = dict(kv_dtype=kv_dtype, page_size=workload.get("page_size", 16),
              weight_dtype=workload.get("weight_dtype"))
    runs = {}
    for name, ticks in (("single", 1), ("graphed", None)):
        engine = serving_engine(model, decode_ticks=ticks, **kw)
        with tick_taps(engine) as taps, finite_taps(model, taps):
            warm_up(engine, prompts)
            runs[name] = served_run(engine, prompts, f"{label} {name}", key,
                                    layers, taps)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "graphed":
            # the profiler's count of a second run's replays, a window a
            # scan
            with timed_dispatches(engine) as ptimes, \
                    profiled_scans(engine) as (prof, py):
                engine.generate([Request(p, max_new_tokens=NEW)
                                 for p in prompts])
            p_ticks = sum(ptimes["ticks"].values())
            graphed_engine = engine
        del engine
        torch.cuda.empty_cache()
    reqs, outs, wall, launches, mixed, ticks, times, dq = runs["graphed"]
    sreqs, souts, swall, slaunches, smixed, _, stimes, _ = runs["single"]
    want = {"write": layers * p_ticks, "attention": layers * p_ticks}
    if not p_ticks:
        fail(f"{label}: the second graphed run took no tick")
    int8_weights = workload.get("weight_dtype") == "int8"
    if int8_weights != bool(sum(dq.values())):
        fail(f"{label}: dequant matmul launches {dq}")
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in graphed_engine.k_pools + graphed_engine.v_pools
                   + graphed_engine.k_scales + graphed_engine.v_scales)
    kv_per_token = graphed_engine.kv_bytes_per_token
    del graphed_engine
    gaps = []
    with plain_serving_paths():
        if kv_dtype:
            llama.causal_attention = kv8_attention
        for p, o in zip(prompts, outs):
            ids = torch.tensor([p + o[:-1]], device=dev)
            with torch.no_grad():
                lg = model(ids)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    n_tok = len(prompts) * NEW
    eq = sum(a == b for o, ob in zip(outs, souts) for a, b in zip(o, ob))
    same = ""
    if bf16 is not None:
        eqb = sum(a == b for o, ob in zip(outs, bf16["outs"])
                  for a, b in zip(o, ob))
        same = f" same_as_bf16_kv={eqb}/{n_tok}"
    print(f"{label}: requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={n_tok} launches={launches}"
          f" peak_mem_gb={peak:.2f} kv_pool_bytes={kv_bytes} "
          f"kv_bytes_per_token={kv_per_token}", flush=True)
    print(f"{label} graphed: {run_line(reqs, wall, mixed, ticks, times)} "
          f"plain_forward_exact={exact}/{n_tok} worst_gap={worst:.4f} "
          f"gap_p90={float(gaps.quantile(0.9)):.4f} "
          f"equal_to_single_steps={eq}/{n_tok}{same}", flush=True)
    print(f"{label} single steps (decode_ticks=1): "
          f"{run_line(sreqs, swall, smixed, 0, stimes)} launches={slaunches}",
          flush=True)
    print(f"{label} graphed, profiler over a second run's scans (a window "
          f"a scan): launches {dict(prof)} (want {want}, a write and an "
          f"attention a layer a tick, {p_ticks} ticks; the wrappers' "
          f"{dict(py)})", flush=True)
    hold_profiled(f"{label} graphed, profiled scans", prof, py)
    if any(prof.get(k) != n for k, n in want.items()):
        fail(f"{label} graphed, profiled run: launches {dict(prof)}, want "
             f"{want}")
    if exact < EXACT_FLOOR * n_tok:
        fail(f"{label}: only {exact}/{n_tok} served tokens are the plain "
             f"forward's argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"{label}: served token {worst:.3f} below the plain forward's "
             "argmax")
    if tick_check:
        torch.cuda.empty_cache()
        check_tick_replay(serving_engine(model, **kw), label, prompts,
                          TICK_MODES)
    return dict(launches=launches + slaunches, outs=outs, single_outs=souts,
                tps=n_tok / wall, single_tps=n_tok / swall)


# phase 9's engine paths: keyword arguments, launches per layer per
# dispatch, and the launch-count key (+ "_q8" on int8 pools)
LADDER = {"rope-fused": ({}, 2, "fused_rope"),
          "fused-kv": ({"fused_rope": False}, 2, "fused"),
          "two-op": ({"fused_kv": False}, 1, "ragged")}


@contextlib.contextmanager
def recorded_attention(engine, store):
    """While the first dispatch of ``engine`` runs, append to ``store``
    a copy of each layer's attention output; after it, a copy of every
    pool and sidecar."""
    from paddle_tpu_torch.inference import serving
    names = ("fused_ragged_paged_attention", "ragged_paged_attention")
    saved = [getattr(serving, n) for n in names]
    dispatch = engine._dispatch_rows

    def recording(fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            if "pools" not in store:
                store.setdefault("attn", []).append(out.clone())
            return out
        return wrapper

    def first_dispatch(rows, cow=()):
        out = dispatch(rows, cow)
        if "pools" not in store:
            store["mixed"] = any(n > 1 for _, _, _, n, _, _ in rows)
            store["pools"] = [t.clone() for t in engine.k_pools
                              + engine.v_pools + engine.k_scales
                              + engine.v_scales]
        return out
    for n, fn in zip(names, saved):
        setattr(serving, n, recording(fn))
    engine._dispatch_rows = first_dispatch
    try:
        yield store
    finally:
        for n, fn in zip(names, saved):
            setattr(serving, n, fn)
        del engine._dispatch_rows


# phase 9b: the engine at geometries and dtypes past phase 4's, at
# Llama-3-8B width cut to LADDER_LAYERS layers (2 for the f16 int8 model):
# label -> workload
SERVE_DOMAIN = {"serve page 64": dict(page_size=64),
                "serve f32 model": dict(dtype="float32"),
                "serve f16 int8 weights": dict(dtype="float16",
                                               weight_dtype="int8",
                                               layers=2)}


def serve_domain(dev):
    """Phase 9b: serve phase 4's prompts at 64-slot pages (bf16), with an
    f32 model (pages of 16) and with an f16 model in int8 weights (the
    dequant matmul's cluster instance on f16 x), each through the
    rope-fused kernels with every launch counted, no plain version
    called and every token held against the model's plain forward at
    phase 4's floors. Returns the launches of #12 over the runs."""
    import torch
    launches = 0
    for label, workload in SERVE_DOMAIN.items():
        launches += serve(dev, label=label, **dict(
            dict(layers=LADDER_LAYERS), **workload))["launches"]
        torch.cuda.empty_cache()
    return launches


def ladder_run(engine, prompts, label, key, per_layer, first=None):
    """One run of phase 4's requests through ``engine.generate`` with
    every launch counted (``per_layer`` a layer a dispatch or tick) and
    no plain version called; ``first``: a store for
    :func:`recorded_attention`. Returns (outs, pools, wall, dispatches,
    ticks, launches)."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    record = recorded_attention(engine, first) if first is not None \
        else contextlib.nullcontext()
    with count_calls(serving_plain_versions()) as plain_calls, record, \
            timed_dispatches(engine) as times:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
    ticks = sum(times["ticks"].values())
    dispatches = len(times["mixed"]) + len(times["decode"])
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    want = {k: 0 for k in launches}
    want[key] = per_layer * LADDER_LAYERS * (dispatches + ticks)
    if launches != want or (first is not None and not first.get("mixed")):
        fail(f"{label}: kernel launches {launches} != {want}, or the first "
             "dispatch was not a mixed one")
    pools = engine.k_pools + engine.v_pools + engine.k_scales \
        + engine.v_scales
    return outs, pools, wall, dispatches, ticks, launches[key]


def serve_ladder(dev):
    """Phase 9: Llama-3-8B width at LADDER_LAYERS layers serves phase 4's
    prompts through the engine's three attention paths (rope-fused #12 /
    #13, ``fused_rope=False`` #11a / #11b, ``fused_kv=False`` #10 / #9
    after the PyTorch scatter) for both KV dtypes, each path twice: with
    ``decode_ticks=1`` (single mixed steps, whose first dispatch's
    attention outputs and pools are recorded) and graphed (decode scans
    replaying each path's tick graph). Per dtype and per way, the greedy
    tokens must be identical across the paths and the final pools and
    sidecars bitwise equal; with ``decode_ticks=1`` also every layer's
    attention output and the pools after the first (mixed) dispatch.
    Every launch counted (2 a layer a dispatch or tick fused, 1 two-op)
    and no plain version called; then phase 4b's tick check (greedy) on
    each path. Returns the launches of each path by its launch-count
    key."""
    import torch
    cfg, model = llama_model(dev, LADDER_LAYERS)
    prompts = serving_prompts(cfg.vocab_size)
    counts = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for path, (kw, per_layer, key) in LADDER.items():
            key += "_q8" if kv_dtype else ""
            label = f"ladder {kv_dtype or 'bf16'} {path}"
            single = serving_engine(model, kv_dtype, decode_ticks=1, **kw)
            single.prewarm([single.chunk_budget, single.max_batch], [])
            first = {}
            souts, spools, swall, sdisp, _, sl = ladder_run(
                single, prompts, f"{label} single", key, per_layer, first)
            graphed = serving_engine(model, kv_dtype, **kw)
            warm_up(graphed, prompts)
            outs, pools, wall, disp, ticks, gl = ladder_run(
                graphed, prompts, f"{label} graphed", key, per_layer)
            counts[key] = sl + gl
            runs[path] = (souts, first, spools, outs, pools)
            print(f"{label}: single steps dispatches={sdisp} wall_s="
                  f"{swall:.3f} tokens_per_s={len(prompts) * NEW / swall:.1f}"
                  f"; graphed dispatches={disp} ticks={ticks} wall_s="
                  f"{wall:.3f} tokens_per_s={len(prompts) * NEW / wall:.1f}"
                  f"; launches {sl} + {gl}", flush=True)
            check_tick_replay(serving_engine(model, kv_dtype, **kw), label,
                              prompts)
            del single, graphed
            torch.cuda.empty_cache()
        souts0, first0, spools0, outs0, pools0 = runs["rope-fused"]
        for path in ("fused-kv", "two-op"):
            souts, first, spools, outs, pools = runs[path]
            label = f"ladder {kv_dtype or 'bf16'} {path}"
            if souts != souts0 or outs != outs0:
                fail(f"{label}: greedy tokens differ from the rope-fused "
                     "path's (single steps or graphed)")
            for what, a, b in (("first-dispatch attention", first["attn"],
                                first0["attn"]),
                               ("first-dispatch pools", first["pools"],
                                first0["pools"]),
                               ("final pools, single steps", spools,
                                spools0),
                               ("final pools, graphed", pools, pools0)):
                if len(a) != len(b) or not all(torch.equal(x, y)
                                               for x, y in zip(a, b)):
                    fail(f"{label}: {what} differ from the rope-fused "
                         "path's bit for bit")
        n_attn = len(first0["attn"])
        eq = sum(a == b for o, ob in zip(outs0, souts0) for a, b in zip(o, ob))
        print(f"ladder {kv_dtype or 'bf16'}: greedy tokens identical across "
              f"the three paths, single steps and graphed; first mixed "
              f"dispatch's attention outputs ({n_attn} layers) and pools "
              f"({len(pools0)} tensors) bitwise equal; final pools bitwise "
              f"equal, single steps and graphed; graphed tokens equal to "
              f"single steps' {eq}/{len(prompts) * NEW}", flush=True)
    return counts


def paged_batch(dev, ctxs, dtype, seed=0, spare=16):
    """Decode rows at Llama-3-8B attention width (32 q / 8 kv heads,
    head_dim 128, page 16): row i attends ``ctxs[i]`` keys over pages
    drawn from a seeded permutation of the pool, its table's tail
    poisoned with ids outside ``[0, P)``; q and pools random in
    ``dtype`` from a seeded generator on the card. Returns the
    wrapper's keyword arguments."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    n_pages = [-(-c // PAGE) for c in ctxs]
    num_pages = sum(n_pages) + spare
    perm = rng.permutation(num_pages)
    width = max(n_pages) + 2
    tables = np.empty((len(ctxs), width), np.int32)
    used = 0
    for i, n in enumerate(n_pages):
        tables[i] = rng.choice([-5, 10 ** 7, num_pages + 11], width)
        tables[i, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=dtype, generator=g)
    return dict(q=rand(len(ctxs), H, D), k_pages=rand(num_pages, HK, PAGE, D),
                v_pages=rand(num_pages, HK, PAGE, D),
                block_tables=torch.from_numpy(tables).to(dev),
                context_lens=torch.tensor(ctxs, dtype=torch.int32,
                                          device=dev))


def paged_bound(args):
    """Least time the card could take for one decode call: the keys each
    row attends (K and V, once), q and out, the live table entries and
    the lens over the memory rate, or 4 x D flops per (query head, key)
    pair over the rate of the pools' type; the larger wins."""
    import torch
    q, kp, lens = args["q"], args["k_pages"], args["context_lens"]
    page = kp.shape[2]
    n = lens.long().clamp(0, args["block_tables"].shape[1] * page)
    keys = int(n.sum())
    entries = int(((n + page - 1) // page).sum())
    nbytes = (2 * keys * HK * D * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4 * (entries + len(n)))
    peak = BF16_FLOPS if kp.dtype == torch.bfloat16 else F32_FLOPS
    return roofline(nbytes, 4 * D * H * keys, peak)


def check_paged(dev, label, ctxs, dtype, against_ragged=False):
    """Phase 3e: the decode paged attention kernel (#4) against its
    plain version on one batch of ``paged_batch`` rows, and, with
    ``against_ragged``, against #10's decode-only launch over the same
    pools (q at position ctx - 1, one query a row); returns its numbers
    and an inactive row's output must be exact zeros."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    args = paged_batch(dev, ctxs, dtype)
    before = PA.launches["paged"]
    out = PA.paged_attention(**args)
    if PA.launches["paged"] != before + 1:
        fail(f"paged attention {label}: the wrapper did not launch the "
             "kernel once")
    ref = PA.paged_attention_ref(**args)
    torch.cuda.synchronize()
    if out.dtype != args["q"].dtype or out.shape != args["q"].shape:
        fail(f"paged attention {label}: out {out.dtype} {tuple(out.shape)}")
    err = check_close(f"paged attention {label}: kernel out (row, head, "
                      "col)", out, ref)
    vs_ragged = ""
    if against_ragged:
        lens = args["context_lens"]
        out10 = rpa.ragged_paged_attention(
            args["q"][:, None], args["k_pages"], args["v_pages"],
            args["block_tables"], lens, (lens - 1).clamp_min(0),
            (lens > 0).int())[:, 0]
        torch.cuda.synchronize()
        e10 = check_close(f"paged attention {label}: #4 against #10 "
                          "(row, head, col)", out, out10)
        vs_ragged = f" vs_ragged_err={e10:.3e}"
    ms = time_ms(lambda: PA.paged_attention(**args))
    dev_ms = device_ms(lambda: PA.paged_attention(**args))
    plain_ms = time_ms(lambda: PA.paged_attention_ref(**args), iters=5,
                       warmup=1)
    # library yardstick: SDPA over the gathered K/V (kv heads repeated to
    # H) with a length mask; the port never calls it
    p = args["k_pages"].shape[0]
    tables = args["block_tables"].long().clamp(0, p - 1)
    b = tables.shape[0]

    def gathered(pool):
        x = pool[tables].transpose(2, 3).reshape(b, -1, HK, D)
        return x.repeat_interleave(H // HK, dim=2).transpose(1, 2)
    kg, vg = gathered(args["k_pages"]), gathered(args["v_pages"])
    mask = (torch.arange(kg.shape[2], device=dev)[None, :]
            < args["context_lens"].long()[:, None])[:, None, None, :]
    qs = args["q"][:, :, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask))
    del kg, vg
    bound_ms, bound_by = paged_bound(args)
    print(f"kernel check (paged_attention, {label}): rows={b} dtype="
          f"{str(dtype).replace('torch.', '')} keys="
          f"{int(args['context_lens'].sum())} pages={p} out_err={err:.3e} "
          f"(tol 1 ulp + {OUT_VEC} x head-vector max){vs_ragged} "
          f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def paged_forms(dev, ctxs):
    """The reference's other operand forms of #4 (C9), each ``(label,
    args)``: int64 tables and lens, bf16 q over f32 pools, f32 q over
    bf16 pools, raw int8 pools (values in [-127, 127], q scaled down so
    the scores stay in exp's range), a strided q; and the widest group,
    512 query heads a kv head (H 1024, Hk 2) at head_dim 256 in f32."""
    import torch
    bf = paged_batch(dev, ctxs, torch.bfloat16)
    f32 = paged_batch(dev, ctxs, torch.float32)
    g = torch.Generator(dev).manual_seed(3)
    q8 = {k: torch.randint(-127, 128, bf[k].shape, device=dev, generator=g,
                           dtype=torch.int8) for k in ("k_pages", "v_pages")}
    q = bf["q"]
    yield "int64 tables and lens", dict(
        bf, block_tables=bf["block_tables"].long(),
        context_lens=bf["context_lens"].long())
    yield "bf16 q over f32 pools", dict(f32, q=f32["q"].bfloat16())
    yield "f32 q over bf16 pools", dict(bf, q=q.float())
    yield "raw int8 pools", dict(bf, **q8, q=q / 16)
    yield "strided q", dict(bf, q=torch.cat([q, q], dim=-1)[..., :D])
    n_pages = [-(-c // 8) for c in (0, 1, 300, 129)]
    tables = torch.arange(sum(n_pages), device=dev).split(n_pages)
    width = max(n_pages)
    yield "group 512 (H 1024, Hk 2, head_dim 256, f32)", dict(
        q=torch.randn(4, 1024, 256, device=dev, generator=g),
        k_pages=torch.randn(sum(n_pages), 2, 8, 256, device=dev,
                            generator=g),
        v_pages=torch.randn(sum(n_pages), 2, 8, 256, device=dev,
                            generator=g),
        block_tables=torch.stack([torch.cat([t, t.new_zeros(width - len(t))])
                                  for t in tables]).int(),
        context_lens=torch.tensor([0, 1, 300, 129], dtype=torch.int32,
                                  device=dev))


def check_paged_forms(dev, ctxs):
    """Phase 3e, C9: each of :func:`paged_forms` through the public
    function in exactly one #4 launch and no plain call, against the
    plain version within the kernel bound; returns the largest error."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as PA
    errs = []
    for label, args in paged_forms(dev, ctxs):
        before = PA.launches["paged"]
        inst = dict(PA.instance_launches)
        with count_calls([(PA, "paged_attention_ref")]) as calls:
            out = PA.paged_attention(**args)
        if PA.launches["paged"] != before + 1 or calls:
            fail(f"paged attention, {label}: {PA.launches['paged'] - before}"
                 f" launches, {len(calls)} plain calls (want 1 and 0)")
        ref = PA.paged_attention_ref(**args)
        torch.cuda.synchronize()
        if out.dtype != args["q"].dtype or out.shape != args["q"].shape:
            fail(f"paged attention, {label}: out {out.dtype} "
                 f"{tuple(out.shape)}")
        err = check_close(f"paged attention, {label}: kernel out (row, "
                          "head, col)", out, ref)
        errs.append(err)
        which = [k for k, n in PA.instance_launches.items() if n != inst[k]]
        print(f"kernel check (paged_attention, {label}): instance="
              f"{which[0]} out_err={err:.3e} (tol 1 ulp + {OUT_VEC} x "
              "head-vector max)", flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def check_paged_kernel(dev):
    """Phase 3e: #4 at phase 3's decode-only shape (8 rows, contexts
    64-544, bf16 and f32; the bf16 pools through #10 too), at Llama-3-8B's
    full context (32 rows, bf16, contexts over 1-8192 and an inactive
    row) and in the reference's other operand forms (C9,
    :func:`check_paged_forms`). Returns #4's JSON entry (without
    ``launches``), with the full-context times, the shape phase 10
    runs."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    ctxs = rng.randint(64, 545, 8).tolist()
    # 1, a page multiple, the whole context, an inactive row, the rest
    # uniform over 1..FULL_CTX
    full_ctxs = [1, FULL_CTX // 2, FULL_CTX, 0] \
        + rng.randint(1, FULL_CTX + 1, 28).tolist()
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        r = check_paged(dev, f"decode {str(dtype).replace('torch.', '')}",
                        ctxs, dtype, against_ragged=dtype == torch.bfloat16)
        errs.append(r["max_abs_err"])
    full = check_paged(dev, "full context", full_ctxs, torch.bfloat16)
    full.pop("device_ms")
    # the forms' errors scale with their values (int8 pools: up to 127),
    # so they stand apart from the main shapes'
    forms_err = check_paged_forms(dev, ctxs)
    torch.cuda.empty_cache()
    return dict(name="paged_attention", route="cuda", source=PA_SOURCE,
                replaces=PA_REPLACES,
                **dict(full, max_abs_err=max(errs + [full["max_abs_err"]]),
                       forms_max_abs_err=forms_err))


def decode_cache(dev):
    """Phase 10: the slice's path. One ``PagedKVCache`` at Llama-3-8B's
    attention width on the card; 32 sequences admitted with seeded
    prompts of 1-8160 tokens and their K/V written; 32 decode steps of
    ``extend`` + ``write`` + ``attend``; half the sequences released and
    16 new ones admitted on the recycled pages, 8 more steps. Every
    ``attend`` must launch #4 once and never the plain version; the
    first and last step of each stretch are held against the plain
    version on the same pools. Returns #4's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.ops import paged_attention as PA
    rng = np.random.RandomState(10)
    g = torch.Generator(dev).manual_seed(10)

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.bfloat16,
                           generator=g)
    torch.cuda.reset_peak_memory_stats()
    cache = PagedKVCache(CACHE_PAGES, PAGE, HK, D, dtype=torch.bfloat16,
                         device=dev)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (cache.k_pages, cache.v_pages))

    def admit(sids):
        lens = rng.randint(1, CACHE_PROMPT + 1, len(sids))
        for sid, n in zip(sids, lens.tolist()):
            cache.admit(sid, n)
            cache.write(sid, rand(n, HK, D), rand(n, HK, D))
        return int(lens.sum())

    live = list(range(CACHE_ROWS))
    prompt_tokens = admit(live)
    plain_calls, times, checked = [], [], 0
    launched = []

    def stretch(steps):
        nonlocal checked
        for step in range(steps):
            for sid in live:
                cache.extend(sid, 1)
                cache.write(sid, rand(1, HK, D), rand(1, HK, D))
            q = rand(len(live), H, D)
            before = PA.launches["paged"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_calls([(PA, "paged_attention_ref")]) as calls:
                out = cache.attend(live, q)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            plain_calls.extend(calls)
            launched.append(PA.launches["paged"] - before)
            if tuple(out.shape) != (len(live), H, D) \
                    or not bool(torch.isfinite(out).all()):
                fail(f"decode cache: bad attend output at step {step}")
            if step in (0, steps - 1):
                ref = cache.attend(live, q, use_kernel=False)
                check_close(f"decode cache step {step}: attend (row, head, "
                            "col)", out, ref)
                checked += 1

    reset_launches()
    stretch(CACHE_STEPS)
    released = set()
    for sid in live[:CACHE_ROWS // 2]:
        released.update(cache.export_table(sid)[0])
        cache.release(sid)
    new = list(range(CACHE_ROWS, CACHE_ROWS + CACHE_ROWS // 2))
    live = live[CACHE_ROWS // 2:] + new
    refill_tokens = admit(new)
    reused = len(released & {p for s in new
                             for p in cache.export_table(s)[0]})
    if not reused:
        fail("decode cache: the new sequences got none of the released "
             "pages")
    stretch(CACHE_REFILL_STEPS)
    launches = PA.launches["paged"]
    attends = CACHE_STEPS + CACHE_REFILL_STEPS
    if plain_calls:
        fail(f"decode cache: the plain version ran on the card "
             f"({len(plain_calls)} calls)")
    if launched != [1] * attends or launches != attends:
        fail(f"decode cache: #4 launches per attend {launched} (want one "
             "each)")
    if PA.instance_launches["tensor-core"] < attends:
        fail(f"decode cache: #4's tensor-core instance ran "
             f"{PA.instance_launches['tensor-core']} of {attends} attends")
    dev_ms = device_ms(lambda: cache.attend(live, rand(len(live), H, D)))
    keys = sum(cache.context_len(s) for s in live)
    attend_ms = 1e3 * sum(times) / len(times)
    print(f"decode cache: pages={CACHE_PAGES} pool_bytes={pool_bytes} "
          f"rows={len(live)} prompt_tokens={prompt_tokens} "
          f"refill_prompt_tokens={refill_tokens} recycled_pages={reused} "
          f"attends={attends} launches={launches} "
          f"checked_steps={checked} final_keys={keys} attend_ms_mean="
          f"{attend_ms:.4f} attend_ms_max={1e3 * max(times):.4f} "
          f"device_ms={dev_ms:.4f} host_share="
          f"{max(0.0, 1 - dev_ms / attend_ms):.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)
    return launches


def flash_registers():
    """``ptxas -v`` lines of the flash kernels, of the ragged attention's
    tensor-core instance and write launch, of the decode paged
    attention's (#4) instances, of the loss kernel's tensor-core instance
    and of the GEMM kernels' cluster instances: registers and spills of
    each instance, from the builds' logs."""
    import re
    from paddle_tpu_torch.ops import _build
    lines = []
    for mangled, what in sorted(_build.ptxas_report(
            "ragged_paged_attention").items()):
        m = re.search(r"attention_tcILb(\d)ELb(\d)E(?:13(__nv_bfloat16)|"
                      r"6(__half))Li(\d+)E", mangled)
        if m:
            lines.append(f"ptxas: attention_tc<{m.group(1)}, {m.group(2)}, "
                         f"{m.group(3) or m.group(4)}, {m.group(5)}>: {what}")
        m = re.search(r"kv_write_kernelILb(\d)ELb(\d)E(?:13(__nv_bfloat16)|"
                      r"6(__half)|(f))E", mangled)
        if m:
            t = m.group(3) or m.group(4) or "float"
            lines.append(f"ptxas: kv_write_kernel<{m.group(1)}, "
                         f"{m.group(2)}, {t}>: {what}")
    for mangled, what in sorted(_build.ptxas_report(
            "paged_attention").items()):
        m = re.search(r"decode_tcI(\w+?)Li(\d+)E", mangled)
        if m:
            pool = "bf16" if "bfloat16" in m.group(1) else "f16"
            q = "f32" if m.group(1).endswith("f") else pool
            lines.append(f"ptxas: paged decode_tc<pools {pool}, q {q}, "
                         f"{m.group(2)}>: {what}")
        m = re.search(r"decode_generalI([fa])E", mangled)
        if m:
            pool = {"f": "f32", "a": "int8"}[m.group(1)]
            lines.append(f"ptxas: paged decode_general<pools {pool}>: "
                         f"{what}")
    for mangled, what in sorted(_build.ptxas_report(
            "flash_attention").items()):
        m = re.search(r"(flash_[a-z_]+)I(?:Li(\d+)E|(f)E|6(__half)E|"
                      r"13(__nv_bfloat16)E)", mangled)
        arg = next(g for g in m.groups()[1:] if g) if m else ""
        name = f"{m.group(1)}<{'float' if arg == 'f' else arg}>" if m \
            else mangled
        lines.append(f"ptxas: {name}: {what}")
    for lib, kernel in (("dequant_matmul", "dq_cluster_kernel"),
                        ("grouped_gemm", "q8_cluster_kernel")):
        for mangled, what in sorted(_build.ptxas_report(lib).items()):
            m = re.search(kernel + r"I(?:6(__half)|13(__nv_bfloat16))"
                          r"Li(\d)E", mangled)
            if m:
                lines.append(f"ptxas: {kernel}<{m.group(1) or m.group(2)}, "
                             f"{m.group(3)}>: {what}")
    for mangled, what in sorted(_build.ptxas_report("grouped_gemm").items()):
        m = re.search(r"float_cluster_kernelI(?:6(__half)|13(__nv_bfloat16))"
                      r"Li(\d)ELb(\d)E", mangled)
        if m:
            t = m.group(1) or m.group(2)
            lines.append(f"ptxas: float_cluster_kernel<{t}, {m.group(3)}, "
                         f"k-major {m.group(4)}>: {what}")
    for mangled, what in sorted(_build.ptxas_report(
            "fused_linear_cross_entropy").items()):
        m = re.search(r"(linear_ce_fwd_tc)ILb(\d)ELb(\d)E", mangled)
        if m:
            lines.append(f"ptxas: {m.group(1)}<h f32: {m.group(2)}, w f32: "
                         f"{m.group(3)}>: {what}")
    return lines


def attention_pairs(b, h, sq, sk, causal):
    """Unmasked (query, key) pairs of one attention call."""
    if not causal:
        return b * h * sq * sk
    off = sk - sq
    return b * h * sum(min(sk, i + off + 1) for i in range(sq))


def roofline(nbytes, ops, peak):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bounds(b, sq, sk, causal):
    """Bound of each flash kernel: q/k/v (and dO, lse, delta) read once,
    outputs written once, bf16; 4/6/8 x D flops per unmasked pair."""
    pairs = attention_pairs(b, H, sq, sk, causal)
    q_b, kv_b, rows = b * sq * H * D * 2, b * sk * HK * D * 2, b * H * sq * 4
    return {"forward": roofline(2 * q_b + 2 * kv_b + rows, 4 * D * pairs,
                                BF16_FLOPS),
            "dq": roofline(3 * q_b + 2 * kv_b + 2 * rows, 6 * D * pairs,
                           BF16_FLOPS),
            "dkv": roofline(2 * q_b + 4 * kv_b + 2 * rows, 8 * D * pairs,
                            BF16_FLOPS)}


def flash_case(dev, label, b, sq, sk, causal, seed, timed, d=D,
               dtype="bfloat16"):
    """The three flash kernels against the plain versions on one batch
    at the Llama-3-8B head counts (head_dim ``d``, ``dtype`` q/k/v); the
    backward kernels get the plain forward's lse and delta, so each
    kernel is checked alone. Prints the instance each kernel ran
    (``kernel_instance``'s rule). Returns ({kernel: max abs err},
    {kernel: timings} if ``timed``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as FT
    g = torch.Generator(dev).manual_seed(seed)
    bf = dict(device=dev, dtype=getattr(torch, dtype), generator=g)
    q, do = torch.randn(b, sq, H, d, **bf), torch.randn(b, sq, H, d, **bf)
    k, v = torch.randn(b, sk, HK, d, **bf), torch.randn(b, sk, HK, d, **bf)
    scale = 1.0 / math.sqrt(d)
    args = (q, k, v, causal, scale)
    before = dict(FT.instance_launches)
    out, lse = FT._launch_forward(*args)
    out_r, lse_r = FT.flash_attention_fwd_ref(*args)
    delta = FT.attention_delta(out_r, do)
    bargs = (q, k, v, do, lse_r, delta, causal, scale)
    dq = FT._launch_dq(*bargs)
    dk, dv = FT._launch_dkv(*bargs)
    dq_r, dk_r, dv_r = FT.flash_attention_bwd_ref(*bargs)
    torch.cuda.synchronize()
    err = {"forward": check_close(f"flash {label} out", out, out_r),
           "dq": check_close(f"flash {label} dq", dq, dq_r, GRAD_FLOOR),
           "dkv": max(check_close(f"flash {label} dk", dk, dk_r, GRAD_FLOOR),
                      check_close(f"flash {label} dv", dv, dv_r,
                                  GRAD_FLOOR))}
    lse_err = float((lse - lse_r).abs().max())
    if not lse_err <= LSE_ABS:
        fail(f"flash {label}: lse differs by {lse_err} > {LSE_ABS}")
    if any(x.dtype != q.dtype for x in (out, dq, dk, dv)):
        fail(f"flash {label}: outputs not in the inputs' dtype {q.dtype}")
    ran = sorted(k_ for k_, n in FT.instance_launches.items()
                 if n > before[k_])
    print(f"flash check ({label}): B={b} Sq={sq} Sk={sk} D={d} {dtype} "
          f"causal={causal} instances={','.join(ran)} "
          f"out_err={err['forward']:.3e} lse_err={lse_err:.3e} "
          f"dq_err={err['dq']:.3e} dkv_err={err['dkv']:.3e}", flush=True)
    if len(ran) != 3:
        fail(f"flash {label}: instances {ran}, not one per kernel")
    if not timed:
        if dtype != "bfloat16" or d not in (64, 128):
            print(f"flash {label} times (general instance): forward_ms="
                  f"{time_ms(lambda: FT._launch_forward(*args), 5, 1):.4f}"
                  f" dq_ms={time_ms(lambda: FT._launch_dq(*bargs), 5, 1):.4f}"
                  f" dkv_ms="
                  f"{time_ms(lambda: FT._launch_dkv(*bargs), 5, 1):.4f}",
                  flush=True)
        return err, None
    t = {"forward": time_ms(lambda: FT._launch_forward(*args)),
         "dq": time_ms(lambda: FT._launch_dq(*bargs)),
         "dkv": time_ms(lambda: FT._launch_dkv(*bargs))}
    dev_t = {"forward": device_ms(lambda: FT._launch_forward(*args)),
             "dq": device_ms(lambda: FT._launch_dq(*bargs)),
             "dkv": device_ms(lambda: FT._launch_dkv(*bargs))}
    plain_fwd = time_ms(lambda: FT.flash_attention_fwd_ref(*args), iters=3,
                        warmup=1)
    plain_bwd = time_ms(lambda: FT.flash_attention_bwd_ref(*bargs), iters=3,
                        warmup=1)
    # library yardstick (never called by the port): SDPA with GQA on the
    # head-major views, forward alone and forward + backward
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def lib_step():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                       enable_gqa=True).backward(doh)
    lib_both = time_ms(lib_step)
    bounds = flash_bounds(b, sq, sk, causal)
    timing = {}
    for name in ("forward", "dq", "dkv"):
        bound_ms, bound_by = bounds[name]
        timing[name] = dict(
            ms=t[name], plain_ms=plain_fwd if name == "forward" else plain_bwd,
            library_ms=lib_fwd if name == "forward" else lib_both - lib_fwd,
            bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_t[name],
            instance=[k_ for k_ in ran if k_.startswith(name + ".")][0])
        print(f"flash {name}: instance={timing[name]['instance']} "
              f"ms={t[name]:.4f} device_ms={dev_t[name]:.4f} plain_ms="
              f"{timing[name]['plain_ms']:.3f} library_ms="
              f"{timing[name]['library_ms']:.4f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    print(f"flash library: sdpa_fwd_ms={lib_fwd:.4f} sdpa_fwd_bwd_ms="
          f"{lib_both:.4f}", flush=True)
    return err, timing


# phase 3b: the general instance (f32 FMAs) at points of the reference's
# domain past bf16 head_dim 64/128, the last at phase 19b(ii)'s float16
# training batch: label -> (b, sq, sk, causal, d, dtype)
FLASH_DOMAIN = {"f32 d128": (1, 512, 512, True, 128, "float32"),
                "bf16 d96": (1, 512, 512, True, 96, "bfloat16"),
                "bf16 d256": (1, 256, 256, False, 256, "bfloat16"),
                "f16 d64": (1, 256, 384, True, 64, "float16"),
                "f16 train": (TRAIN_B, TRAIN_S, TRAIN_S, True, 128,
                              "float16")}


def check_flash(dev):
    """Phase 3b, flash attention: the Llama-3-8B training batch (timed;
    the forward is the wgmma instance), a non-causal batch and a causal
    one with fewer queries than keys, then the general instance at
    FLASH_DOMAIN's points. Returns the three kernels' JSON entries
    (without ``launches``)."""
    from paddle_tpu_torch.ops import _build
    err, timing = flash_case(dev, "train", TRAIN_B, TRAIN_S, TRAIN_S, True,
                             seed=1, timed=True)
    report = _build.ptxas_report("flash_attention")
    for name in ("dq", "dkv"):
        regs = [v for k, v in report.items()
                if f"flash_{name}_wgmmaILi128E" in k]
        print(f"flash {name}: instance={timing[name]['instance']} registers "
              f"(D 128, at launch): {', '.join(regs)}", flush=True)
    for label, args in (("non-causal", (1, 512, 512, False)),
                        ("short-q", (1, 256, 768, True))):
        e, _ = flash_case(dev, label, *args, seed=2, timed=False)
        err = {k: max(err[k], e[k]) for k in err}
    for label, (b, sq, sk, causal, d, dtype) in FLASH_DOMAIN.items():
        e, _ = flash_case(dev, label, b, sq, sk, causal, seed=3,
                          timed=False, d=d, dtype=dtype)
        err = {k: max(err[k], e[k]) for k in err}
    return [dict(name=FA_NAMES[k], route="cuda", source=FA_SOURCE,
                 replaces=FA_REPLACES[k], max_abs_err=err[k], **timing[k])
            for k in ("forward", "dq", "dkv")]


def ce_point(dev, label, h, w, lab, want, timed=False, loss_scale=1.0):
    """The loss and its gradients through the public function against
    the plain path on one set of inputs: the loss within LOSS_REL; f32
    gradients within GRAD_REL of their largest value, 16-bit ones within
    phase 3's bound (1 bf16 ulp plus 2^-10 of the row's largest value: a
    16-bit gradient rounds where an lse 1e-7 away rounds otherwise). The
    gradients are those of ``loss_scale`` x the loss, as a GradScaler's
    backward takes them. The forward must launch the ``want`` instance;
    with ``timed``, the kernel's time by CUDA events and its device time.
    Returns the largest lse/pick error and the times."""
    import torch
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC

    def loss_and_grads():
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = FC.fused_linear_cross_entropy(hg, wg, lab)
        (loss * loss_scale).backward()
        return loss.detach(), hg.grad, wg.grad
    before = dict(FC.instance_launches)
    loss_k, dh_k, dw_k = loss_and_grads()
    ran = [k for k, n in FC.instance_launches.items() if n > before[k]]
    if ran != [want]:
        fail(f"loss {label}: instances {ran}, not {want}")
    lse, pick = FC._launch(h, w, lab)
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab,
                                                      FC.default_chunk())
    err = max(float((lse - lse_r).abs().max()),
              float((pick - pick_r).abs().max()))
    with plain_paths():
        loss_p, dh_p, dw_p = loss_and_grads()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= LOSS_REL:
        fail(f"loss {label}: {float(loss_k)} vs plain {float(loss_p)}: "
             f"{rel:.3e}")
    for name, a, b in (("dh", dh_k, dh_p), ("dW", dw_k, dw_p)):
        if a.dtype != b.dtype or a.dtype != (h if name == "dh" else w).dtype:
            fail(f"loss {label}: {name} in {a.dtype}")
        if a.dtype == torch.float32:
            e = float((a - b).abs().max()) / float(b.abs().max())
            if not e <= GRAD_REL:
                fail(f"loss {label}: {name} differs from the plain path by "
                     f"{e:.3e} of its max")
        else:
            check_close(f"loss {label}: {name} (row, column)", a, b)
    line = (f"loss check ({label}): N={h.shape[0]} D={h.shape[1]} "
            f"V={w.shape[0]} {h.dtype} hidden {w.dtype} weight "
            f"loss_scale={loss_scale:g} instance={want} "
            f"lse_pick_err={err:.3e} loss_rel={rel:.3e}")
    times = {}
    if timed:
        times = dict(ms=time_ms(lambda: FC._launch(h, w, lab), 3, 1),
                     device_ms=device_ms(lambda: FC._launch(h, w, lab), 3))
        line += f" ms={times['ms']:.3f} device_ms={times['device_ms']:.3f}"
    print(line, flush=True)
    return err, times


def check_ce(dev):
    """Phase 3b, the loss: the fused linear cross-entropy kernel (its
    tensor-core instance) against the plain chunked version at N = D =
    4096, V = 128256 in f32, 5% of rows at ignore_index; then the loss
    and its gradients through the kernel path against the plain path;
    then ``ce_point`` at bf16 hidden and weight (same shape, timed), at
    f32 hidden with a bf16 and with an f16 weight (same shape: phase 19's
    O2 and GradScaler routes, the f16 one's loss scaled by SCALER_INIT)
    and at CE_GENERAL (D % 8 != 0: the general
    instance, f16 hidden, f32 weight). Returns the JSON entry (without
    ``launches``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    g = torch.Generator(dev).manual_seed(3)
    h = torch.randn(CE_N, CE_D, device=dev, generator=g)
    w = torch.randn(CE_V, CE_D, device=dev, generator=g) * 0.02
    lab = torch.randint(0, CE_V, (CE_N,), device=dev, generator=g)
    lab[torch.rand(CE_N, device=dev, generator=g) < CE_IGNORED] = -100
    chunk = FC.default_chunk()
    before = dict(FC.instance_launches)
    lse, pick = FC._launch(h, w, lab)
    ran = [k for k, n in FC.instance_launches.items() if n > before[k]]
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab, chunk)
    torch.cuda.synchronize()
    if ran != ["tensor-core"]:
        fail(f"loss kernel: instances {ran}, not the tensor-core one")
    errs = []
    for name, got, ref in (("lse", lse, lse_r), ("pick", pick, pick_r)):
        if not torch.isfinite(got).all():
            fail(f"loss kernel: non-finite {name}")
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
        if not rel <= CE_REL:
            fail(f"loss kernel: {name} differs by {rel:.3e} (relative) > "
                 f"{CE_REL}")
        errs.append(float((got - ref).abs().max()))

    def loss_and_grads():
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = FC.fused_linear_cross_entropy(hg, wg, lab)
        loss.backward()
        return loss.detach(), hg.grad, wg.grad
    loss_k, dh_k, dw_k = loss_and_grads()
    # the backward is the plain chunked code: fed the kernel's lse it
    # gives the same gradients bit for bit
    valid = (lab != -100).float().sum()
    gn = torch.ones(CE_N, device=dev) / valid
    dh_b, dw_b = FC.linear_cross_entropy_backward(h, w, lab, lse, gn, chunk,
                                                  -100)
    if not (torch.equal(dh_k, dh_b) and torch.equal(dw_k, dw_b)):
        fail("loss kernel path: gradients differ from the chunked backward")
    with plain_paths():
        loss_p, dh_p, dw_p = loss_and_grads()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= LOSS_REL:
        fail(f"loss {float(loss_k)} vs plain {float(loss_p)}: {rel:.3e}")
    for name, a, b in (("dh", dh_k, dh_p), ("dW", dw_k, dw_p)):
        e = float((a - b).abs().max()) / float(b.abs().max())
        if not e <= GRAD_REL:
            fail(f"loss {name} differs from the plain path by {e:.3e} of "
                 f"its max")
    del dh_k, dw_k, dh_b, dw_b, dh_p, dw_p
    run = lambda: FC._launch(h, w, lab)  # noqa: E731
    ms = time_ms(run, iters=3, warmup=1)
    dev_ms = device_ms(run, iters=3)
    plain_ms = time_ms(lambda: FC.fused_linear_cross_entropy_ref(
        h, w, lab, chunk), iters=3, warmup=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = time_ms(lambda: F.cross_entropy(F.linear(h, w), lab,
                                                 ignore_index=-100),
                         iters=3, warmup=1)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    nbytes = 4 * CE_N * CE_D + 4 * CE_V * CE_D + 8 * CE_N + 8 * CE_N
    ops = 2 * CE_N * CE_D * CE_V
    # what the kernel does: three TF32 products on the tensor cores; an
    # f32 product on the CUDA cores would take the second bound
    bound_ms, bound_by = roofline(nbytes, 3 * ops, TF32_FLOPS)
    f32_bound_ms, _ = roofline(nbytes, ops, F32_FLOPS)
    regs = [v for k, v in _build.ptxas_report(
        "fused_linear_cross_entropy").items() if "linear_ce_fwd_tcILb1ELb1E" in k]
    print(f"loss kernel check: N={CE_N} D={CE_D} V={CE_V} "
          f"ignored={int(CE_N - valid)} instance={ran[0]} registers="
          f"{','.join(regs)} lse_err={errs[0]:.3e} pick_err={errs[1]:.3e} "
          f"loss={float(loss_k):.6f} plain_loss={float(loss_p):.6f} "
          f"ms={ms:.3f} device_ms={dev_ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} "
          f"({bound_by}, 3xTF32) f32_bound_ms={f32_bound_ms:.3f}",
          flush=True)
    err16, _ = ce_point(dev, "bf16", h.bfloat16(), w.bfloat16(), lab,
                        "tensor-core", timed=True)
    # phase 19's routes: the f32 final-norm output against an O2 bf16
    # head (19a) and a float16 one under 19b(ii)'s loss scale (unscaled,
    # this loss's f16 head gradients, ~1e-7, are f16 subnormals, where
    # an lse 1e-7 away rounds them a step of 2^-24 apart)
    err_mixed = [ce_point(dev, f"f32 hidden, {dt} head", h, w.to(dt), lab,
                          "tensor-core", loss_scale=scale)[0]
                 for dt, scale in ((torch.bfloat16, 1.0),
                                   (torch.float16, SCALER_INIT))]
    del h, w
    torch.cuda.empty_cache()
    n, d, v = CE_GENERAL
    h = torch.randn(n, d, device=dev, generator=g).half()
    w = torch.randn(v, d, device=dev, generator=g) * 0.02
    lab = torch.randint(0, v, (n,), device=dev, generator=g)
    lab[:8] = -100
    err_g, _ = ce_point(dev, "general", h, w, lab, "general")
    return dict(name="fused_linear_cross_entropy_forward", route="cuda",
                source="paddle_tpu_torch/csrc/fused_linear_cross_entropy.cu",
                replaces="paddle_tpu/ops/fused_linear_cross_entropy.py:220",
                max_abs_err=max(errs + err_mixed + [err16, err_g]), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, f32_bound_ms=f32_bound_ms,
                library_ms=library_ms, instance=ran[0])


@contextlib.contextmanager
def plain_paths():
    """Route flash attention and the loss to their plain versions on the
    card (the comparison runs only)."""
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    saved = FT._launch_forward, FT._launch_backward, FC._launch
    FT._launch_forward = FT.flash_attention_fwd_ref
    FT._launch_backward = FT.flash_attention_bwd_ref
    FC._launch = lambda h, w, lab: FC.fused_linear_cross_entropy_ref(
        h, w, lab, FC.default_chunk())
    try:
        yield
    finally:
        FT._launch_forward, FT._launch_backward, FC._launch = saved


@contextlib.contextmanager
def counted_plain_versions():
    """Count every call of the training path's plain versions (flash
    forward/backward, the loss, the plain attention composition)."""
    from paddle_tpu_torch.nn.functional import attention as FA
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    with count_calls([(FT, "flash_attention_fwd_ref"),
                      (FT, "flash_attention_bwd_ref"),
                      (FC, "fused_linear_cross_entropy_ref"),
                      (FA, "_naive_attention")]) as calls:
        yield calls


@contextlib.contextmanager
def count_calls(targets):
    """Count every call of the functions ``(module, name)`` in
    ``targets`` (looked up as module globals by their callers)."""
    calls = []
    saved = [getattr(m, n) for m, n in targets]

    def counted(name, fn):
        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapper
    for (m, n), fn in zip(targets, saved):
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(targets, saved):
            setattr(m, n, fn)


def training_model(dev, layers):
    """Llama-3-8B width cut to ``layers`` layers, f32 weights drawn from
    a seeded generator on the card, and one fixed seeded batch of
    ``[TRAIN_B, TRAIN_S + 1]`` token ids."""
    import numpy as np
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    model = build_model("8b", layers, dev, seed=0)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int64)
    return model, ids


def train(dev):
    """Phase 5: train the 8-layer model through the recipe's entry
    point; returns the launches of each kernel in that run and the mean
    step time."""
    import torch
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    t0 = time.perf_counter()
    model, ids = training_model(dev, TRAIN_LAYERS)
    torch.cuda.synchronize()
    print(f"model: llama3_8b width, layers={TRAIN_LAYERS} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with counted_plain_versions() as plain_calls:
        reset_launches()
        res = llama_pretrain.train(
            model, TRAIN_STEPS, TRAIN_B, TRAIN_S, lr=3e-4, weight_decay=0.1,
            use_amp=True, source=itertools.repeat(ids),
            log=lambda line: print("train: " + line, flush=True))
        torch.cuda.synchronize()
        launches = dict(FT.launches, ce=FC.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls:
        fail(f"plain versions ran on the card: {sorted(set(plain_calls))}")
    want = dict(forward=TRAIN_STEPS * TRAIN_LAYERS,
                dq=TRAIN_STEPS * TRAIN_LAYERS,
                dkv=TRAIN_STEPS * TRAIN_LAYERS, ce=TRAIN_STEPS)
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    steady = res["step_s"][2:]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_B * TRAIN_S
    tflops = model.flops_per_token(TRAIN_S) * tokens / step_s / 1e12
    print(f"train: layers={TRAIN_LAYERS} batch={TRAIN_B} seq={TRAIN_S} "
          f"steps={TRAIN_STEPS} loss_first={losses[0]:.4f} loss_last="
          f"{losses[-1]:.4f} step_ms={step_s * 1e3:.1f} (mean of steps "
          f"3-{TRAIN_STEPS}) tokens_per_s={tokens / step_s:.0f} "
          f"tflops={tflops:.1f} peak_mem_gb={peak:.2f} launches={launches}",
          flush=True)
    return launches, step_s


def compare_step(dev, use_amp=True):
    """Phase 5b: one step (loss and gradients, no update) of a 2-layer
    model at full width through the kernels, against the same step
    through the plain versions, on the same weights and batch: under
    bf16 ``auto_cast`` (the flash kernels' tensor-core instances), and
    with ``use_amp=False`` in f32 (their general instance)."""
    import contextlib as cl
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as FT
    model, ids = training_model(dev, 2)
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    names = ["lm_head.weight", "model.layers.0.self_attn.q_proj.weight",
             "model.embed_tokens.weight"]
    params = dict(model.named_parameters())

    def step():
        with (amp.auto_cast(dtype="bfloat16") if use_amp
              else cl.nullcontext()):
            loss, _ = model(x, y)
        loss.backward()
        grads = [params[n].grad.clone() for n in names]
        model.zero_grad(set_to_none=True)
        return loss.item(), grads
    before = dict(FT.instance_launches)
    loss_k, g_k = step()
    ran = sorted(k for k, n in FT.instance_launches.items()
                 if n > before[k])
    with plain_paths():
        loss_p, g_p = step()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    line = [f"loss={loss_k:.5f} plain_loss={loss_p:.5f} rel={rel:.2e}"]
    if not rel <= STEP_LOSS_REL:
        fail(f"2-layer step: loss {loss_k} vs plain {loss_p}")
    for n, a, b in zip(names, g_k, g_p):
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        ratio = float(a.double().norm() / b.double().norm())
        line.append(f"{n}: cos={cos:.6f} norm_ratio={ratio:.5f}")
        if not (cos >= GRAD_COS and abs(ratio - 1) <= GRAD_NORM):
            fail(f"2-layer step: grad of {n} cos {cos} norm ratio {ratio}")
    want = ["dkv.wgmma", "dq.wgmma", "forward.wgmma"] if use_amp \
        else ["dkv.general", "dq.general", "forward.general"]
    if ran != want:
        fail(f"2-layer step: flash instances {ran} != {want}")
    print(f"compare step (2 layers, {'bf16 auto_cast' if use_amp else 'f32'}"
          f", kernels vs plain; flash {','.join(ran)}): " + " ".join(line),
          flush=True)


# phase 18: the pretraining recipe whole (8 samples of TRAIN_S + 1 tokens
# in the corpus, so the feed cycles its epochs), the 2-layer cut of
# phases 5b and 18b-18d, and the steps of 18b/18c
PRETRAIN_SAMPLES = 8
PRETRAIN_CUT = 2
COMPARE_STEPS, OPT_STEPS = 6, 3
# 18d: one layer at full width (the embedding and head are 85% of the
# 2-layer cut's parameters; one layer less trims the checkpoint's bytes
# and the run's seconds)
CKPT_CUT = 1
# 18d: host memory and disk a checkpoint needs, x its bytes (the snapshot
# in host memory beside the page cache; one committed copy on disk and
# the next one's .tmp)
CKPT_HOST, CKPT_DISK = 1.25, 2.1
SMOKE_STACKS_S = 1140      # the run's stacks printed if it is still going


def state_digest(tensors):
    """``{name: (sum, weighted sum)}`` of every tensor's bits, computed on
    the card: each element's 16- or 32-bit pattern as an integer, summed
    plain and weighted by its position mod 65521, plus one."""
    import torch
    out = {}
    for name, t in tensors.items():
        t = t.detach().contiguous().view(-1)
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32
                      if t.element_size() == 4 else torch.int64)
        acc = [0, 0]
        for lo in range(0, bits.numel(), 1 << 26):
            v = bits[lo:lo + (1 << 26)].to(torch.int64)
            w = (torch.arange(lo, lo + v.numel(), device=v.device)
                 % 65521) + 1
            acc[0] += int(v.sum())
            acc[1] += int((v * w).sum())
        out[name] = tuple(acc)
    return out


def recipe_digest(model, opt):
    """The digest of the recipe's checkpointed state, flat."""
    d = {f"model.{k}": v for k, v in model.state_dict().items()}
    d.update((f"opt.{k}", v) for k, v in opt.state_dict().items()
             if hasattr(v, "shape"))
    return state_digest(d)


def corpus(dirname, vocab, samples=PRETRAIN_SAMPLES, seq=TRAIN_S, seed=7):
    """A seeded int32 token corpus of ``samples`` samples of ``seq + 1``
    ids in ``dirname``; returns its path."""
    import numpy as np
    path = os.path.join(dirname, "corpus.bin")
    np.random.RandomState(seed).randint(
        0, vocab, (samples, seq + 1)).astype(np.int32).tofile(path)
    return path


def recipe_args(path, layers, steps, *extra):
    return ["--config", "8b", "--layers", str(layers), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--amp", "--steps",
            str(steps), "--data", path, *extra]


def replay_launches(step):
    """The flash and loss kernels' launches one replay of the compiled
    step ``step`` adds: ``{"forward", "dq", "dkv", "ce"}``."""
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    (_, counts, _), = step._graphs._graphs.values()
    per = dict.fromkeys(("forward", "dq", "dkv", "ce"), 0)
    for c, d in counts:
        if c is FT.launches:
            per.update(d)
        elif c is FC.instance_launches:
            per["ce"] += sum(d.values())
    return per


def compiles_of(name):
    from paddle_tpu_torch.observability import compile_watch as cw
    return sum(1 for e in cw.recent_compile_events()
               if e.get("kind") == "compile" and e.get("name") == name)


def pretrain_compiled(dev, eager_step_s, path):
    """Phase 18a: the recipe's entry point at Llama-3-8B width and
    phase 5's cut, its step compiled into one CUDA graph, batches from
    the native ``TokenFeed``; returns the run's kernel launches."""
    import torch
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = compiles_of("llama_pretrain.step")
    with counted_plain_versions() as plain_calls:
        reset_launches()
        res = llama_pretrain.main(recipe_args(
            path, TRAIN_LAYERS, TRAIN_STEPS))
        torch.cuda.synchronize()
        launches = dict(FT.launches, ce=FC.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls:
        fail(f"18a: plain versions ran: {sorted(set(plain_calls))}")
    if res["feed"] != "paddle_tpu_torch.native.TokenFeed":
        fail(f"18a: batches came from {res['feed']}, not the native feed")
    step = res["step"]
    captures = compiles_of("llama_pretrain.step") - before
    if len(step._cache) != 1 or captures != 1:
        fail(f"18a: {len(step._cache)} graphs, {captures} captures "
             "(want one of each)")
    per = replay_launches(step)
    want = dict(forward=TRAIN_LAYERS, dq=TRAIN_LAYERS, dkv=TRAIN_LAYERS,
                ce=1)
    if per != want:
        fail(f"18a: launches per replay {per} != {want}")
    # the eager warm-up, the capture's warm-up step and the replays: one
    # step each
    total = {k: v * (TRAIN_STEPS + 1) for k, v in want.items()}
    if launches != total:
        fail(f"18a: launches {launches} != {total}")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"18a: losses not finite and falling: {losses}")
    steady = res["step_s"][2:]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_B * TRAIN_S
    model = res["model"]
    tflops = model.flops_per_token(TRAIN_S) * tokens / step_s / 1e12
    print(f"18a compiled recipe: layers={TRAIN_LAYERS} batch={TRAIN_B} "
          f"seq={TRAIN_S} steps={TRAIN_STEPS} feed={res['feed']} "
          f"loss_first={losses[0]:.4f} loss_last={losses[-1]:.4f} "
          f"step_ms={step_s * 1e3:.1f} (graphed, mean of steps "
          f"3-{TRAIN_STEPS}) eager_step_ms={eager_step_s * 1e3:.1f} "
          f"(phase 5, this run) tokens_per_s={tokens / step_s:.0f} "
          f"tflops={tflops:.1f} peak_mem_gb={peak:.2f} "
          f"launches_per_replay={per} captures={captures}", flush=True)
    return launches, step_s


def compare_loops(label, make, batches, use_amp):
    """``make()`` -> ``(model, opt, sched)`` twice from one seed: one copy
    stepped eagerly, the other through ``jit.to_static`` (its first call
    eager, its second captured, the rest replays), over ``batches``; one
    copy on the card at a time. Fails unless every loss and the digest of
    every parameter and optimizer tensor are equal (each tensor that
    differs named), the device learning rate after each replay is
    ``float32(sched())``, and one graph was captured. Returns the
    losses, the replays' lr values and the number of tensors held."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, jit
    runs = {}
    for kind in ("eager", "compiled"):
        model, opt, sched = make()

        def step_fn(ids, labels, model=model, opt=opt):
            with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
                loss, _ = model(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        name = f"chip_smoke.{label}"
        step = step_fn if kind == "eager" else jit.to_static(
            step_fn, state=[model, opt], name=name)
        before = compiles_of(name)
        losses, lrs = [], []
        for i, ids in enumerate(batches):
            x = torch.from_numpy(ids[:, :-1]).to(dev_of(model))
            y = torch.from_numpy(ids[:, 1:]).to(dev_of(model))
            losses.append(step(x, y).item())
            if kind == "compiled" and i >= 2:
                got = opt.lr_tensor().item()
                if got != float(np.float32(opt.get_lr())):
                    fail(f"{label}: device lr {got} after replay {i} != "
                         f"float32({opt.get_lr()})")
                lrs.append(got)
            if sched is not None:
                sched.step()
        if kind == "compiled":
            captures = compiles_of(name) - before
            if len(step._cache) != 1 or captures != 1:
                fail(f"{label}: {len(step._cache)} graphs, {captures} "
                     "captures (want one)")
        runs[kind] = (losses, recipe_digest(model, opt))
        del model, opt, sched, step, step_fn, x, y
        gc.collect()
        torch.cuda.empty_cache()
    (le, de), (lc, dc) = runs["eager"], runs["compiled"]
    diffs = [] if le == lc else [f"losses {le} vs {lc}"]
    diffs += [n for n in de if de[n] != dc.get(n)]
    if diffs or sorted(de) != sorted(dc):
        fail(f"{label}: compiled differs from eager: {diffs[:8]}")
    return le, lrs, len(de)


def dev_of(model):
    return next(model.parameters()).device


def compiled_equals_eager(dev):
    """Phase 18b: AdamW with ``LinearWarmup(CosineAnnealingDecay)`` and
    ``ClipGradByGlobalNorm(1.0)`` on the 2-layer full-width model,
    compiled against eager over six batches, under bf16 ``auto_cast``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    rng = np.random.RandomState(11)
    vocab = 128256
    batches = [rng.randint(0, vocab, (TRAIN_B, TRAIN_S + 1)).astype(np.int64)
               for _ in range(COMPARE_STEPS)]

    def make():
        model = build_model("8b", PRETRAIN_CUT, dev, seed=0)
        sched = lr.LinearWarmup(
            lr.CosineAnnealingDecay(3e-4, T_max=COMPARE_STEPS),
            warmup_steps=3, start_lr=3e-5, end_lr=3e-4)
        opt = AdamW(learning_rate=sched, weight_decay=0.1,
                    parameters=model.named_parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        return model, opt, sched
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with counted_plain_versions() as plain_calls:
        losses, lrs, n = compare_loops("18b", make, batches, use_amp=True)
    if plain_calls:
        fail(f"18b: plain versions ran: {sorted(set(plain_calls))}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"18b compiled vs eager (2 layers, AdamW, warmup+cosine, global "
          f"norm clip 1.0, bf16 auto_cast): {COMPARE_STEPS} steps bitwise "
          f"equal (losses and the digests of {n} parameters and optimizer "
          f"tensors); one "
          f"capture; replay lrs {lrs} equal float32(scheduler()); losses "
          f"{[round(x, 4) for x in losses]} peak_mem_gb={peak:.2f}",
          flush=True)


def optimizers_compiled(dev):
    """Phase 18c: each optimizer other than Adam/AdamW captured for 3
    steps against 3 eager steps on the tiny config, bitwise."""
    import numpy as np
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    kinds = {"SGD": dict(learning_rate=0.1),
             "Momentum": dict(learning_rate=0.05, use_nesterov=True,
                              weight_decay=0.01),
             "Adagrad": dict(learning_rate=0.05),
             "Adamax": dict(learning_rate=0.01),
             "RMSProp": dict(learning_rate=0.01, centered=True,
                             momentum=0.5),
             "Adadelta": dict(learning_rate=1.0),
             "Lamb": dict(learning_rate=0.01)}
    rng = np.random.RandomState(12)
    batches = [rng.randint(0, 128, (2, 129)).astype(np.int64)
               for _ in range(OPT_STEPS)]
    done = []
    for kind, kw in kinds.items():
        def make(kind=kind, kw=kw):
            model = build_model("tiny", None, dev, seed=0)
            return model, getattr(O, kind)(
                parameters=model.named_parameters(), **kw), None
        losses, _, n = compare_loops(f"18c.{kind}", make, batches,
                                     use_amp=False)
        done.append(f"{kind} ({n} tensors, loss {losses[-1]:.4f})")
    print(f"18c optimizers compiled vs eager, {OPT_STEPS} steps each, "
          f"bitwise: {', '.join(done)}", flush=True)


def host_room(dirname, nbytes):
    """Fail unless the host has ``CKPT_HOST`` x ``nbytes`` of memory
    available and ``dirname``'s disk ``CKPT_DISK`` x ``nbytes`` free;
    returns the two amounts."""
    import shutil
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    free = shutil.disk_usage(dirname).free
    if avail < CKPT_HOST * nbytes or free < CKPT_DISK * nbytes:
        fail(f"18d: a {nbytes} byte checkpoint needs {CKPT_HOST}x host "
             f"memory and {CKPT_DISK}x disk; the host has {avail} bytes "
             f"available and {dirname} {free} bytes free")
    return avail, free


def checkpoint_resume(dev, path):
    """Phase 18d: the recipe with ``--ckpt-dir`` and again with
    ``--resume`` (1 layer at full width), then ``CheckpointManager``'s
    async save during steps and ``restore_latest`` into a model built
    afresh; each restored state's digest equal to the saved one's."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.distributed.checkpoint_manager import \
        CheckpointManager
    from paddle_tpu_torch.examples import llama_pretrain as LP
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        model = LP.build_model("8b", CKPT_CUT, dev, seed=0)
        # f32 weights and two AdamW moments
        need = 3 * sum(p.numel() * 4 for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        avail, free = host_room(tmp, need)
        recipe_dir = os.path.join(tmp, "recipe")
        res = LP.main(recipe_args(path, CKPT_CUT, 2, "--ckpt-dir",
                                  recipe_dir))
        saved = recipe_digest(res["model"], res["opt"])
        line = [f"host_available={avail} disk_free={free}; recipe save: "
                f"{res['ckpt_bytes']} bytes snapshot_s="
                f"{res['snapshot_s']:.2f} write_s={res['write_s']:.2f}"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        res = LP.main(recipe_args(path, CKPT_CUT, 0, "--ckpt-dir",
                                  recipe_dir, "--resume"))
        if "load_s" not in res:
            fail("18d: --resume did not load the checkpoint")
        if recipe_digest(res["model"], res["opt"]) != saved:
            fail("18d: the state --resume restored differs from the saved")
        line.append(f"--resume load_s={res['load_s']:.2f} (state equal)")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(recipe_dir)

        def compiled_run():
            model = LP.build_model("8b", CKPT_CUT, dev, seed=3)
            opt = LP.AdamW(learning_rate=3e-4, weight_decay=0.1,
                           parameters=model.named_parameters())

            def step_fn(ids, labels):
                with amp.auto_cast(dtype="bfloat16"):
                    loss, _ = model(ids, labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            step = jit.to_static(step_fn, state=[model, opt],
                                 warmup="once")
            return model, opt, step
        model, opt, step = compiled_run()
        rng = np.random.RandomState(13)

        def batch(s):
            ids = rng.randint(0, 128256, (TRAIN_B, s + 1))
            return (torch.from_numpy(ids[:, :-1]).to(dev),
                    torch.from_numpy(ids[:, 1:]).to(dev))
        step(*batch(128))                       # the eager warm-up
        for _ in range(2):
            step(*batch(TRAIN_S)).item()
        state = LP.train_state(model, opt)
        nbytes = sum(t.numel() * t.element_size()
                     for t in state["model"].values()) + sum(
            t.numel() * t.element_size() for t in state["opt"].values()
            if hasattr(t, "shape"))
        want = recipe_digest(model, opt)
        mgr = CheckpointManager(os.path.join(tmp, "mgr"), max_to_keep=2,
                                async_save=True)
        t0 = time.perf_counter()
        mgr.save(state, 1, blocking=False)
        t1 = time.perf_counter()
        step(*batch(TRAIN_S)).item()            # a step during the write
        t2 = time.perf_counter()
        mgr.wait()
        t3 = time.perf_counter()
        mgr.verify_step(1)
        t4 = time.perf_counter()
        del model, opt, step, state
        gc.collect()
        torch.cuda.empty_cache()
        model, opt, step = compiled_run()
        step(*batch(128))        # makes the optimizer state to restore into
        t5 = time.perf_counter()
        got = mgr.restore_latest(LP.train_state(model, opt))
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        if got != 1 or recipe_digest(model, opt) != want:
            fail(f"18d: restore_latest gave step {got}; state equal: "
                 f"{recipe_digest(model, opt) == want}")
        line.append(
            f"manager: {nbytes} bytes, snapshot_s={t1 - t0:.2f} (D2H, the step "
            f"waits) step_during_write_s={t2 - t1:.2f} write_commit_s="
            f"{t3 - t1:.2f} (write, fsync, CRC, rename) verify_crc_s="
            f"{t4 - t3:.2f} restore_s={t6 - t5:.2f} (verify and load; "
            "state equal)")
        print("18d checkpoint and resume: " + "; ".join(line), flush=True)
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def pretrain_phase(dev, eager_step_s):
    """Phase 18: 18a-18d; returns 18a's kernel launches and its graphed
    step's seconds."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of "
          "the card held by earlier phases at its start", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        path = corpus(tmp, 128256)
        launches, step_s = pretrain_compiled(dev, eager_step_s, path)
        for sub in (compiled_equals_eager, optimizers_compiled,
                    lambda dev: checkpoint_resume(dev, path)):
            gc.collect()
            torch.cuda.empty_cache()
            sub(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, step_s


# phase 19: training, the rest: Model.fit under O2 (19a, 19b(i)), the
# float16 GradScaler (19b(ii)), recompute (19b(iii)), attention dropout
# (19b(iv)) and the callbacks, metrics and Model.save/load (19c)
FIT_STEPS = 10           # 19a: Model.fit's batches (one epoch)
FIT_VOCAB = 8192         # 19a/19b: the corpus' ids (a learnable marginal)
FIT_EVAL, FIT_PREDICT = 2, 1     # 19a: evaluate and predict batches
FIT_COMPARE_STEPS = 4    # 19b(i): O2 fit, jit=True against jit=False
SCALER_STEPS, SCALER_OVERFLOW = 4, 2   # 19b(ii): steps, the forced one
SCALER_INIT = 2.0 ** 16   # 19b(ii): GradScaler's init_loss_scaling
DROPOUT_P = 0.1          # 19b(iv)
DROPOUT_CHECKED = 1 << 22    # 19b(iv): mask elements held against the CPU
EARLY_EPOCHS = 8         # 19c: EarlyStopping's epoch budget


def fit_corpus(samples, seed):
    """A seeded int32 corpus of ``samples`` rows of ``TRAIN_S + 1`` ids
    below ``FIT_VOCAB``."""
    import numpy as np
    return np.random.RandomState(seed).randint(
        0, FIT_VOCAB, (samples, TRAIN_S + 1)).astype(np.int32)


def token_dataset(rows):
    """A map-style ``io.Dataset`` of ``(ids, next ids)`` int64 pairs."""
    import numpy as np
    from paddle_tpu_torch.io import Dataset

    class Tokens(Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            r = rows[i].astype(np.int64)
            return r[:-1], r[1:]
    return Tokens()


def fit_loader(rows, workers=0, generator=19):
    """``DataLoader`` over :func:`token_dataset` shuffled by a
    ``RandomSampler`` with an int generator, ``TRAIN_B`` a batch."""
    from paddle_tpu_torch import io
    ds = token_dataset(rows)
    return io.DataLoader(ds, batch_sampler=io.BatchSampler(
        sampler=io.RandomSampler(ds, generator=generator),
        batch_size=TRAIN_B), num_workers=workers)


def hapi_llama(dev, layers, seed=0, level="O2", dtype="bfloat16", jit=True,
               steps=FIT_STEPS):
    """A Llama-3-8B-width model cut to ``layers`` as a ``hapi.Model``: the
    network returns the final hidden states and the loss is the fused
    linear cross-entropy over the lm head, as ``forward(labels=)``
    computes it; AdamW with warm-up and cosine; ``amp.decorate`` at
    ``level``. Returns ``(Model, lm, opt, sched)``."""
    import torch
    from paddle_tpu_torch import amp, hapi
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.ops.fused_linear_cross_entropy import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.optimizer import AdamW, lr
    lm = build_model("8b", layers, dev, seed=seed)

    class Hidden(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm = lm

        def forward(self, ids):
            return self.lm.model(ids)

    def loss(hidden, labels):
        return fused_linear_cross_entropy(hidden, lm.lm_head.weight, labels,
                                          ignore_index=-100)
    net = Hidden()
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=steps),
                            warmup_steps=3, start_lr=3e-5, end_lr=3e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.1,
                parameters=net.named_parameters())
    if level == "O2":
        amp.decorate(net, opt, level="O2", dtype=dtype)
    model = hapi.Model(net)
    model.prepare(opt, loss, jit=jit,
                  amp_configs={"level": level, "dtype": dtype})
    return model, lm, opt, sched


def step_recorder():
    """A callback recording each train step's wall time (the step ends
    with the loss read to the host) and loss."""
    from paddle_tpu_torch.hapi import Callback

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.s, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.s.append(time.perf_counter() - self._t0)
            self.losses.append(logs["loss"])
    return Steps()


def o2_state_ok(label, net, opt):
    """Fail unless every parameter outside the norms is bf16 with an f32
    master weight, and every norm weight f32 with none; returns the
    parameters counted."""
    import torch
    masters = opt._accumulators["master_weight"]
    n16 = 0
    for name, p in net.named_parameters():
        m = masters.get(id(p))
        if "norm" in name:
            ok = p.dtype == torch.float32 and m is None
        else:
            ok = p.dtype == torch.bfloat16 and m is not None and \
                m.dtype == torch.float32
            n16 += ok
        if not ok:
            fail(f"{label}: parameter {name} is {p.dtype} with master "
                 f"{None if m is None else m.dtype}")
    return n16


def fit_o2(dev, o1_step_s):
    """Phase 19a: ``Model.fit`` at Llama-3-8B width, 8 layers, O2 (bf16
    parameters, f32 masters and moments), the step one CUDA graph, batches
    from a shuffled 2-worker ``DataLoader``, the LR scheduler, History and
    MetricsCallback; then ``evaluate`` and ``predict``. Returns the run's
    kernel launches."""
    import torch
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    t0 = time.perf_counter()
    model, lm, opt, sched = hapi_llama(dev, TRAIN_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = fit_corpus(FIT_STEPS * TRAIN_B + (FIT_EVAL + FIT_PREDICT)
                      * TRAIN_B, seed=19)
    train_rows = rows[:FIT_STEPS * TRAIN_B]
    eval_rows = rows[FIT_STEPS * TRAIN_B:(FIT_STEPS + FIT_EVAL) * TRAIN_B]
    pred_rows = rows[(FIT_STEPS + FIT_EVAL) * TRAIN_B:]
    reg = om.MetricsRegistry()
    fpt = lm.flops_per_token(TRAIN_S)
    metrics_cb = hapi.MetricsCallback(
        batch_size=TRAIN_B, flops_per_sample=fpt * TRAIN_S / 3,
        peak_flops=BF16_FLOPS, registry=reg, sample_memory=False)
    rec = step_recorder()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = compiles_of("hapi.train_step")
    with counted_plain_versions() as plain_calls:
        reset_launches()
        hist = model.fit(fit_loader(train_rows, workers=2), epochs=1,
                         verbose=0, callbacks=[
                             hapi.LRScheduler(by_step=True), metrics_cb,
                             rec])
        torch.cuda.synchronize()
        fit_launches = dict(FT.launches, ce=FC.launches)
        eval_logs = model.evaluate(fit_loader(eval_rows), verbose=0)
        preds = model.predict(fit_loader(pred_rows))
        torch.cuda.synchronize()
        launches = dict(FT.launches, ce=FC.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls:
        fail(f"19a: plain versions ran: {sorted(set(plain_calls))}")
    step = model._train_step
    captures = compiles_of("hapi.train_step") - before
    if len(step._cache) != 1 or captures != 1:
        fail(f"19a: {len(step._cache)} graphs, {captures} captures (want "
             "one of each)")
    per = replay_launches(step)
    want = dict(forward=TRAIN_LAYERS, dq=TRAIN_LAYERS, dkv=TRAIN_LAYERS,
                ce=1)
    if per != want:
        fail(f"19a: launches per replay {per} != {want}")
    # the eager warm-up, the capture's real step and the replays: one step
    # each; evaluate runs the forwards and the loss, predict the forwards
    total = {k: v * FIT_STEPS for k, v in want.items()}
    if fit_launches != total:
        fail(f"19a: fit launches {fit_launches} != {total}")
    total["forward"] += TRAIN_LAYERS * (FIT_EVAL + FIT_PREDICT)
    total["ce"] += FIT_EVAL
    if launches != total:
        fail(f"19a: fit, evaluate and predict launches {launches} != "
             f"{total}")
    losses = rec.losses
    if len(losses) != FIT_STEPS or not all(math.isfinite(x)
                                           for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"19a: losses not {FIT_STEPS} finite and falling: {losses}")
    if hist.history[-1]["loss"] != losses[-1]:
        fail(f"19a: History {hist.history} != the last step's loss")
    n16 = o2_state_ok("19a", model.network, opt)
    steps_total = metrics_cb._steps.value
    mfu = metrics_cb._mfu.value
    if steps_total != FIT_STEPS or not 0.0 < mfu <= 1.0:
        fail(f"19a: train_steps_total {steps_total} (want {FIT_STEPS}), "
             f"train_mfu {mfu} (want in (0, 1])")
    if not math.isfinite(eval_logs.get("loss", float("nan"))) or \
            preds[0].shape != (TRAIN_B, TRAIN_S, lm.config.hidden_size) or \
            not bool(torch.isfinite(torch.from_numpy(preds[0])).all()):
        fail(f"19a: evaluate {eval_logs} / predict "
             f"{[p.shape for p in preds]} not finite of the right shape")
    steady = rec.s[2:]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_B * TRAIN_S
    tflops = fpt * tokens / step_s / 1e12
    print(f"19a Model.fit O2: layers={TRAIN_LAYERS} params="
          f"{lm.num_params()} ({n16} bf16 with f32 masters) init_s="
          f"{init_s:.1f} batch={TRAIN_B} seq={TRAIN_S} steps={FIT_STEPS} "
          f"loss_first={losses[0]:.4f} loss_last={losses[-1]:.4f} "
          f"step_ms={step_s * 1e3:.1f} (graphed, mean of steps "
          f"3-{FIT_STEPS}) o1_step_ms={o1_step_s * 1e3:.1f} (18a, this run) "
          f"tokens_per_s={tokens / step_s:.0f} tflops={tflops:.1f} "
          f"train_mfu={mfu:.4f} peak_mem_gb={peak:.2f} "
          f"launches_per_replay={per} captures={captures} "
          f"eval_loss={eval_logs['loss']:.4f} lr_last={opt.get_lr():.3e}",
          flush=True)
    del model, lm, opt, sched, step, hist, preds, metrics_cb, rec
    return launches


def fit_compare(dev):
    """Phase 19b(i): O2 ``fit`` with ``jit=True`` against ``jit=False``
    at the 2-layer cut, one model on the card at a time: losses,
    parameters, master weights and moments bitwise."""
    import torch
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.ops import flash_attention as FT
    rows = fit_corpus(FIT_COMPARE_STEPS * TRAIN_B, seed=20)
    runs = {}
    for jit in (False, True):
        model, lm, opt, sched = hapi_llama(dev, PRETRAIN_CUT, jit=jit,
                                           steps=FIT_COMPARE_STEPS)
        rec = step_recorder()
        before = dict(FT.instance_launches)
        model.fit(fit_loader(rows), epochs=1, verbose=0,
                  callbacks=[hapi.LRScheduler(by_step=True), rec])
        torch.cuda.synchronize()
        ran = sorted(k for k, n in FT.instance_launches.items()
                     if n > before[k])
        if ran != ["dkv.wgmma", "dq.wgmma", "forward.wgmma"]:
            fail(f"19b(i): flash instances {ran} under O2 bf16")
        runs[jit] = (rec.losses, recipe_digest(model.network, opt))
        del model, lm, opt, sched
        gc.collect()
        torch.cuda.empty_cache()
    (le, de), (lc, dc) = runs[False], runs[True]
    diffs = [] if le == lc else [f"losses {le} vs {lc}"]
    diffs += [n for n in de if de[n] != dc.get(n)]
    if diffs or sorted(de) != sorted(dc):
        fail(f"19b(i): jit=True differs from jit=False: {diffs[:8]}")
    masters = sum(1 for n in de if n.endswith("_master_weight"))
    print(f"19b(i) O2 fit jit=True vs jit=False (2 layers): "
          f"{FIT_COMPARE_STEPS} steps bitwise (losses and the digests of "
          f"{len(de)} tensors, {masters} master weights); losses "
          f"{[round(x, 4) for x in le]}", flush=True)


def scaler_run(dev, compiled):
    """19b(ii)'s loop: float16 O2 at the 2-layer cut under
    ``GradScaler(2**16)``, ``SCALER_STEPS`` steps, step
    ``SCALER_OVERFLOW`` forced to overflow by a scale past f16's range
    (set in place between steps), the scale put back after it. Returns
    the losses and, around the overflow step, the digests of the
    parameters and moments and the scales."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.optimizer import AdamW
    model = build_model("8b", PRETRAIN_CUT, dev, seed=1)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                parameters=model.named_parameters())
    amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=SCALER_INIT)

    def step_fn(ids, labels):
        with amp.auto_cast(level="O2", dtype="float16"):
            loss, _ = model(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss
    step = jit.to_static(step_fn, state=[model, opt, scaler],
                         name=f"chip_smoke.19b.{compiled}") \
        if compiled else step_fn
    rows = fit_corpus(SCALER_STEPS * TRAIN_B, seed=21)
    out = {"losses": []}

    def moments():
        return {f"{k}.{a}": t for a in ("moment1", "moment2")
                for k, t in ((opt._names[pid], t) for pid, t in
                             opt._accumulators[a].items())}
    for i in range(SCALER_STEPS):
        ids = torch.from_numpy(rows[i * TRAIN_B:(i + 1) * TRAIN_B]
                               .astype(np.int64)).to(dev)
        if i == SCALER_OVERFLOW:
            scaler.set_init_loss_scaling(2.0 ** 126)
            out["params_before"] = state_digest(dict(
                model.named_parameters()))
            out["moments_before"] = state_digest(moments())
            # what a masked step must leave: each moment decayed by its
            # beta under a zero gradient (one product at a time)
            beta = {"moment1": opt._beta1, "moment2": opt._beta2}
            out["moments_decayed"] = {
                k: state_digest({k: t.mul(beta[k.rsplit(".", 1)[1]])})[k]
                for k, t in moments().items()}
        loss = step(ids[:, :-1], ids[:, 1:]).item()
        out["losses"].append(loss)
        if i == SCALER_OVERFLOW:
            torch.cuda.synchronize()
            out["scale_after"] = float(scaler.get_loss_scaling())
            out["params_after"] = state_digest(dict(
                model.named_parameters()))
            out["moments_after"] = state_digest(moments())
            scaler.set_init_loss_scaling(SCALER_INIT)
    out["dtypes"] = sorted({str(p.dtype) for p in model.parameters()})
    if compiled:
        out["graphs"] = len(step._cache)
    del model, opt, scaler, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scaler_phase(dev):
    """Phase 19b(ii): the float16 GradScaler loop eagerly and compiled;
    the overflow step leaves the parameters bitwise, halves the scale and
    leaves the moments as the reference's semantics for that call require
    (eager: the hard skip, moments unchanged; compiled: the masked step,
    moments decayed by their betas); the later steps resume finite.
    The flash kernels run their f16 (general) instance and the loss its
    f16 weight route, counted."""
    import torch
    from paddle_tpu_torch.models import llama as LM
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    seen = set()
    orig = LM.fused_linear_cross_entropy

    def spy(h, w, *a, **k):
        seen.add((str(h.dtype), str(w.dtype)))
        return orig(h, w, *a, **k)
    LM.fused_linear_cross_entropy = spy
    res = {}
    try:
        with counted_plain_versions() as plain_calls:
            for compiled in (False, True):
                reset_launches()
                res[compiled] = scaler_run(dev, compiled)
                res[compiled]["flash"] = dict(FT.instance_launches)
                res[compiled]["ce"] = FC.launches
    finally:
        LM.fused_linear_cross_entropy = orig
    if plain_calls:
        fail(f"19b(ii): plain versions ran: {sorted(set(plain_calls))}")
    line = []
    for compiled, r in res.items():
        kind = "compiled" if compiled else "eager"
        ok = math.isfinite(r["losses"][-1]) and all(
            math.isfinite(x) for i, x in enumerate(r["losses"])
            if i != SCALER_OVERFLOW)
        want_m = r["moments_decayed"] if compiled else r["moments_before"]
        flash = {k: v for k, v in r["flash"].items() if v}
        want_flash = {f"{k}.general": PRETRAIN_CUT * SCALER_STEPS
                      for k in ("forward", "dq", "dkv")}
        if not ok or r["params_after"] != r["params_before"] or \
                r["scale_after"] != 2.0 ** 125 or \
                r["moments_after"] != want_m or flash != want_flash or \
                r["ce"] != SCALER_STEPS or r["dtypes"] != [
                    "torch.float16", "torch.float32"] or \
                r.get("graphs", 1) != 1:
            fail(f"19b(ii) {kind}: losses {r['losses']}, parameters "
                 f"unchanged {r['params_after'] == r['params_before']}, "
                 f"scale {r['scale_after']}, moments as required "
                 f"{r['moments_after'] == want_m}, flash {flash}, ce "
                 f"{r['ce']}, dtypes {r['dtypes']}")
        line.append(f"{kind}: losses {[round(x, 4) for x in r['losses']]}")
    if seen != {("torch.float32", "torch.float16")}:
        fail(f"19b(ii): the loss took (hidden, weight) dtypes {seen}")
    print(f"19b(ii) float16 O2 under GradScaler(2**16) (2 layers, step "
          f"{SCALER_OVERFLOW} forced to overflow): parameters bitwise, "
          f"scale 2**126 -> 2**125, moments unchanged (eager, hard skip) / "
          f"decayed by their betas (compiled, masked); flash instances "
          f"{sorted(k for k, v in res[True]['flash'].items() if v)}, loss "
          f"on (hidden, weight) {sorted(seen)}; " + "; ".join(line),
          flush=True)


def recompute_phase(dev):
    """Phase 19b(iii): one step (loss and gradients) of the 2-layer model
    under bf16 ``auto_cast`` with recompute none, full and "dots": the
    gradients against none's (max relative error printed; bitwise
    expected); the activations the forward leaves for the backward (the
    card's memory after the forward less before it), "dots" between the
    other two, and the step's peak."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.ops import flash_attention as FT
    model = build_model("8b", PRETRAIN_CUT, dev, seed=2)
    ids = torch.from_numpy(fit_corpus(TRAIN_B, seed=22).astype(np.int64)
                           ).to(dev)
    x, y = ids[:, :-1], ids[:, 1:]
    base, held, peaks, errs, fwd = None, {}, {}, {}, {}
    for mode in (False, True, "dots"):
        model.config.recompute = mode
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = FT.launches["forward"]
        with amp.auto_cast(dtype="bfloat16"):
            loss, _ = model(x, y)
        torch.cuda.synchronize()
        held[mode] = (torch.cuda.memory_allocated() - start) / 2 ** 30
        loss.backward()
        torch.cuda.synchronize()
        peaks[mode] = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
        fwd[mode] = FT.launches["forward"] - before
        grads = {n: p.grad for n, p in model.named_parameters()}
        del loss
        if base is None:
            base = grads
            continue
        rel = 0.0
        for n, g in grads.items():
            d = float((g.float() - base[n].float()).abs().max())
            rel = max(rel, d / max(float(base[n].float().abs().max()),
                                   1e-30))
        errs[mode] = rel
        del grads
    want_fwd = {False: PRETRAIN_CUT, True: 2 * PRETRAIN_CUT,
                "dots": 2 * PRETRAIN_CUT}
    if any(e > 1e-6 for e in errs.values()) or fwd != want_fwd or \
            not held[True] < held["dots"] < held[False]:
        fail(f"19b(iii): max relative gradient errors {errs}, activations "
             f"held {held} GiB, flash forwards {fwd}")
    print(f"19b(iii) recompute (2 layers, one step, bf16 auto_cast): grads "
          f"vs none: full max_rel={errs[True]:.3e} dots max_rel="
          f"{errs['dots']:.3e}; GiB held for the backward: none="
          f"{held[False]:.3f} dots={held['dots']:.3f} full={held[True]:.3f}"
          f"; step peak GiB above its start: none={peaks[False]:.2f} dots="
          f"{peaks['dots']:.2f} full={peaks[True]:.2f}; flash forwards a "
          f"step {fwd}", flush=True)
    del model, base
    gc.collect()
    torch.cuda.empty_cache()


def dropout_phase(dev):
    """Phase 19b(iv): ``scaled_dot_product_attention(dropout_p=0.1,
    training=True)`` at the model's attention shape: no flash launch, the
    keep share within 5 sigma of 0.9, the mask for the key it drew bitwise
    the CPU plain version's over its first ``DROPOUT_CHECKED`` counters;
    with ``training=False`` the flash forward launches again."""
    import torch
    from paddle_tpu_torch.models import llama3_8b_config
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import attention as FA
    from paddle_tpu_torch.ops import flash_attention as FT
    cfg = llama3_8b_config()
    h, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn(TRAIN_B, TRAIN_S, h, d, device=dev, generator=g,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(TRAIN_B, TRAIN_S, hk, d, device=dev, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    before = dict(FT.launches)
    torch.cuda.manual_seed(19)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=DROPOUT_P,
                                         is_causal=True)
    torch.cuda.synchronize()
    if dict(FT.launches) != before or not bool(torch.isfinite(out).all()):
        fail(f"19b(iv): flash launched with dropout on ({before} -> "
             f"{dict(FT.launches)}) or a non-finite output")
    torch.cuda.manual_seed(19)
    key = FA.dropout_key(dev)
    shape = (TRAIN_B, h, TRAIN_S, TRAIN_S)
    keep = FA.dropout_keep_mask(key, shape, DROPOUT_P, dev)
    n = keep.numel()
    share = float(keep.float().mean())
    sigma = (DROPOUT_P * (1 - DROPOUT_P) / n) ** 0.5
    words = tuple(int(w) for w in key)
    cpu = FA.dropout_keep_mask(words, (DROPOUT_CHECKED,), DROPOUT_P,
                               torch.device("cpu"))
    same = torch.equal(keep.reshape(-1)[:DROPOUT_CHECKED].cpu(), cpu)
    # the same key on the card and the CPU, through the plain composition
    # in f32 (the mask bitwise, the products f32-grade)
    small = [t[:, :256].float() for t in (q, k, v)]
    got = FA._naive_attention(*small, None, True, dropout_p=DROPOUT_P,
                              key=key).cpu()
    want = FA._naive_attention(*(t.cpu() for t in small), None, True,
                               dropout_p=DROPOUT_P, key=words)
    out_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        fail(f"19b(iv): the dropped attention at 256 tokens differs from "
             f"the CPU's by {out_err}")
    F.scaled_dot_product_attention(q, k, v, dropout_p=DROPOUT_P,
                                   is_causal=True, training=False)
    torch.cuda.synchronize()
    relaunched = FT.launches["forward"] - before["forward"]
    if abs(share - (1 - DROPOUT_P)) > 5 * sigma or not same or \
            relaunched != 1:
        fail(f"19b(iv): keep share {share} (0.9 +- 5 x {sigma:.2e}), mask "
             f"equal to the CPU's {same}, flash forwards with training="
             f"False {relaunched}, output vs CPU {out_err}")
    print(f"19b(iv) attention dropout p={DROPOUT_P} at [{TRAIN_B}, "
          f"{TRAIN_S}, {h}/{hk}, {d}] bf16 causal: no flash launch, keep "
          f"share {share:.6f} over {n} (sigma {sigma:.2e}), mask bitwise "
          f"the CPU plain version's over {DROPOUT_CHECKED} counters, "
          f"f32 output at 256 tokens vs the CPU {out_err:.3e}; "
          f"training=False "
          f"launched the flash forward again", flush=True)
    del q, k, v, out, keep


def tiny_fit_model(dev, seed=0, classes=True):
    """19c's network: the tiny Llama's last-position logits (``classes``,
    for top-k accuracy) or one sigmoid score (for the binary metrics),
    as a ``hapi.Model`` with AdamW; weights from a seeded CPU generator,
    so a CPU and a card copy are equal."""
    import torch
    from paddle_tpu_torch import hapi
    from paddle_tpu_torch.models import LlamaForCausalLM, tiny_llama_config
    from paddle_tpu_torch.optimizer import AdamW
    lm = LlamaForCausalLM(tiny_llama_config(), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    torch.manual_seed(seed)
    head = torch.nn.Linear(lm.config.hidden_size, 1)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm, self.head = lm, head

        def forward(self, ids):
            if classes:
                return self.lm(ids)[:, -1]
            return torch.sigmoid(self.head(self.lm.model(ids)[:, -1]))
    net = Net().to(dev)
    model = hapi.Model(net)

    def loss(out, label):
        if classes:
            return torch.nn.functional.cross_entropy(out, label)
        return torch.nn.functional.binary_cross_entropy(
            out.reshape(-1), label.float())
    model.prepare(AdamW(learning_rate=1e-2, parameters=net.parameters()),
                  loss, jit=False)
    return model


def tiny_rows(n, seed, binary=False):
    """``n`` seeded samples of 128 ids (the flash kernels' length) and a
    label (the next id, or its parity) as an ``io.Dataset``."""
    import numpy as np
    from paddle_tpu_torch.io import TensorDataset
    ids = np.random.RandomState(seed).randint(0, 128, (n, 129))
    lab = ids[:, -1] % 2 if binary else ids[:, -1]
    return TensorDataset([ids[:, :-1].astype(np.int64),
                          lab.astype(np.int64)])


def tiny_checks(dev):
    """Phase 19c at the tiny config: ``CheckpointCallback`` through
    ``fit`` and a restore; ``Model.save`` / ``load`` bitwise; ``evaluate``
    with Accuracy(topk=(1, 5)), Precision, Recall and Auc on the card
    equal to the same metrics computed on the CPU from the same outputs;
    ``EarlyStopping`` stopping at the epoch the CPU run stops at."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import hapi, io, metric
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    line = []
    try:
        # checkpoints through fit, then a restore into a fresh model
        m = tiny_fit_model(dev)
        cb = hapi.CheckpointCallback(dir=os.path.join(tmp, "ck"),
                                     save_freq_steps=2, async_save=True,
                                     on_preemption=False)
        m.fit(tiny_rows(24, 1), batch_size=4, epochs=1, verbose=0,
              shuffle=False, callbacks=[cb])
        saved = state_digest(m.network.state_dict())
        fresh = tiny_fit_model(dev, seed=5)
        cb2 = hapi.CheckpointCallback(dir=os.path.join(tmp, "ck"),
                                      save_freq_steps=100, async_save=False,
                                      on_preemption=False)
        cb2.set_model(fresh)
        cb2.on_train_begin()
        torch.cuda.synchronize()
        if cb2.restored_step != 5 or cb.manager.committed_steps() != \
                [1, 3, 5] or state_digest(fresh.network.state_dict()) != \
                saved:
            fail(f"19c: restored step {cb2.restored_step}, committed "
                 f"{cb.manager.committed_steps()}, state equal "
                 f"{state_digest(fresh.network.state_dict()) == saved}")
        cb2.on_train_end()
        line.append(f"checkpoint: committed {cb.manager.committed_steps()},"
                    f" restored step {cb2.restored_step} (state equal)")
        # Model.save / load
        path = os.path.join(tmp, "model")
        m.save(path)
        other = tiny_fit_model(dev, seed=6)
        other.fit(tiny_rows(4, 2), batch_size=4, epochs=1, verbose=0)
        other.load(path)
        opt_a, opt_b = m._optimizer.state_dict(), \
            other._optimizer.state_dict()
        if state_digest(other.network.state_dict()) != saved or \
                state_digest({k: v for k, v in opt_a.items()
                              if hasattr(v, "shape")}) != state_digest(
                    {k: v for k, v in opt_b.items() if hasattr(v, "shape")}):
            fail("19c: Model.load did not restore the saved state bitwise")
        line.append("save/load bitwise")
        # metrics on the card against the CPU on the same outputs
        got = {}
        for binary, mets in ((False, [metric.Accuracy(topk=(1, 5))]),
                             (True, [metric.Precision(), metric.Recall(),
                                     metric.Auc()])):
            mm = tiny_fit_model(dev, classes=not binary)
            mm.prepare(mm._optimizer, mm._loss, metrics=mets, jit=False)
            outs = []
            for mt in mets:
                orig = mt.compute

                def spy(pred, *labels, orig=orig, mt=mt):
                    if mt is mets[0]:
                        outs.append((pred.clone(), labels[0].clone()))
                    return orig(pred, *labels)
                mt.compute = spy
            logs = mm.evaluate(tiny_rows(20, 3, binary), batch_size=8,
                               verbose=0)
            if not outs or any(p.device.type != dev.type for p, _ in outs):
                fail("19c: the metrics did not get the card's outputs")
            cpu = [type(mt)(**({"topk": (1, 5)} if not binary else {}))
                   for mt in mets]
            for pred, lab in outs:
                for c in cpu:
                    res = c.compute(pred.cpu(), lab.cpu())
                    c.update(*res) if isinstance(res, tuple) else \
                        c.update(res)
            for mt, c in zip(mets, cpu):
                if mt.accumulate() != c.accumulate():
                    fail(f"19c: {mt.name()} on the card {mt.accumulate()} "
                         f"!= the CPU's {c.accumulate()}")
                got[str(mt.name())] = mt.accumulate()
            del logs
        line.append(f"metrics equal the CPU's: {got}")
        # EarlyStopping on the card and on the CPU
        stops = []
        for d in (dev, torch.device("cpu")):
            mm = tiny_fit_model(d)
            es = hapi.EarlyStopping(monitor="loss", patience=1,
                                    min_delta=0.05)
            hist = mm.fit(io.DataLoader(tiny_rows(16, 4), batch_size=8),
                          epochs=EARLY_EPOCHS, verbose=0, callbacks=[es])
            stops.append((es.stopped_epoch, [round(h["loss"], 4)
                                             for h in hist.history]))
        if stops[0][0] != stops[1][0]:
            fail(f"19c: EarlyStopping stopped at {stops[0]} on the card, "
                 f"{stops[1]} on the CPU")
        line.append(f"EarlyStopping stopped at epoch {stops[0][0]} on both "
                    f"(card losses {stops[0][1]}, CPU {stops[1][1]})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("19c tiny config: " + "; ".join(line), flush=True)


def fit_phase(dev, o1_step_s):
    """Phase 19: 19a-19c; returns 19a's kernel launches."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 19: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of "
          "the card held by earlier phases at its start", flush=True)
    launches = fit_o2(dev, o1_step_s)
    for sub in (fit_compare, scaler_phase, recompute_phase, dropout_phase,
                tiny_checks):
        gc.collect()
        torch.cuda.empty_cache()
        sub(dev)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def moe_bound(gs, c, k, n, w_bytes, scale_rows=0):
    """Bound of one grouped GEMM: the weights of experts with rows (and
    their scale rows) read once, the real x rows read and the whole out
    written once in bf16; 2 x real rows x K x N operations at the bf16
    rate."""
    live = gs.clamp(0, c)
    rows, experts = int(live.sum()), int((live > 0).sum())
    nbytes = experts * (k * n * w_bytes + scale_rows * n * 4) \
        + rows * k * 2 + gs.numel() * c * n * 2 + gs.numel() * 4
    return roofline(nbytes, 2 * rows * k * n, BF16_FLOPS)


def masked_rows(x, gs):
    """``x [E*C, K]`` as ``[E, C, K]`` with rows past each expert's size
    zeroed (the library yardstick's input)."""
    import torch
    e = gs.numel()
    c = x.shape[0] // e
    keep = torch.arange(c, device=x.device)[None, :] < gs.clamp(0, c)[:, None]
    return (x.reshape(e, c, -1) * keep[..., None]).to(x.dtype)


def grouped_case(label, kind, x, w, gs, scales=None, w_lib=None,
                 timed=True):
    """One grouped GEMM launch (``kind`` "float" or "q8") against its
    plain version, with the instance it ran; with ``timed``, its time, the
    plain version's, the library's (``torch.bmm`` on the masked rows
    against ``w_lib``, the bf16 weight) and the bound. Returns the
    numbers."""
    import torch
    from paddle_tpu_torch.ops import grouped_gemm as GG
    e, k, n = w.shape
    c = x.shape[0] // e
    if kind == "q8":
        def run():
            return GG._launch_q8(x, w, scales, gs, WEIGHT_BLOCK)

        def plain():
            return GG.grouped_gemm_q8_ref(x, w, scales, gs, WEIGHT_BLOCK)
        bound_ms, bound_by = moe_bound(gs, c, k, n, 1, k // WEIGHT_BLOCK)
    else:
        def run():
            return GG._launch_float(x, w, gs)

        def plain():
            return GG.grouped_gemm_ref(x, w, gs)
        bound_ms, bound_by = moe_bound(gs, c, k, n, 2)
    before = dict(GG.instance_launches)
    y, ref = run(), plain()
    torch.cuda.synchronize()
    ran = [i for i, n_ in GG.instance_launches.items() if n_ > before[i]]
    err = check_close(f"{label}: out (row, column)", y, ref)
    out = dict(max_abs_err=err, instance=ran[0])
    line = f"moe kernel check ({label}): E={e} C={c} K={k} N={n} " \
        f"gs={gs.tolist()} instance={ran[0]} out_err={err:.3e}"
    if timed:
        xm = masked_rows(x, gs)
        out.update(ms=time_ms(run), device_ms=device_ms(run),
                   plain_ms=time_ms(plain, iters=3, warmup=1),
                   library_ms=time_ms(lambda: torch.bmm(xm, w_lib)),
                   library_device_ms=device_ms(lambda: torch.bmm(xm, w_lib)),
                   bound_ms=bound_ms, bound_by=bound_by)
        line += (f" ms={out['ms']:.4f} device_ms={out['device_ms']:.4f} "
                 f"plain_ms={out['plain_ms']:.3f} library_ms="
                 f"{out['library_ms']:.4f} library_device_ms="
                 f"{out['library_device_ms']:.4f} bound_ms="
                 f"{bound_ms:.5f} ({bound_by})")
    print(line, flush=True)
    return out


def dequant_case(label, x, q, scales, w_lib, block=WEIGHT_BLOCK):
    """The dequant matmul kernel against its plain version on ``x [M,
    K]``, timed (CUDA events, which include the wrapper's host time
    between launches at these sizes, and the profiler's device time),
    with ``F.linear`` on the 16-bit weight ``w_lib [N, K]`` as the
    library yardstick; prints the instance that ran. ``block`` is the
    int8 block (phase 3c's Mixtral shapes use the format's default; a
    C6 point of GEMM_DOMAIN its own)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.quant import kernels as QK
    (m, k), n = x.shape, q.shape[1]
    before = dict(QK.instance_launches)
    y = QK._launch(x, q, scales, block)
    ran = [i for i, c in QK.instance_launches.items() if c > before[i]]
    ref = QK.dequant_matmul_ref(x, q, scales, block)
    torch.cuda.synchronize()
    err = check_close(f"{label}: out (row, column)", y, ref)
    nbytes = k * n + -(-k // block) * n * 4 + m * k * 2 + m * n * 2
    bound_ms, bound_by = roofline(nbytes, 2 * m * k * n, BF16_FLOPS)

    def run():
        return QK._launch(x, q, scales, block)

    def lib():
        return F.linear(x, w_lib)
    out = dict(max_abs_err=err, ms=time_ms(run), device_ms=device_ms(run),
               plain_ms=time_ms(lambda: QK.dequant_matmul_ref(
                   x, q, scales, block), iters=5, warmup=1),
               library_ms=time_ms(lib), library_device_ms=device_ms(lib),
               bound_ms=bound_ms, bound_by=bound_by, instance=ran[0])
    print(f"dequant kernel check ({label}): M={m} K={k} N={n} B={block} "
          f"{x.dtype} instance={ran[0]} out_err={err:.3e} ms={out['ms']:.4f}"
          f" device_ms={out['device_ms']:.4f} plain_ms={out['plain_ms']:.3f}"
          f" library_ms={out['library_ms']:.4f} library_device_ms="
          f"{out['library_device_ms']:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by})", flush=True)
    return out


def check_dequant_rows(x, q, scales, label):
    """Rows 0, 5 and 37 of ``x [64, K]`` through the dequant matmul alone,
    then among the first 8 and all 64 rows: bitwise equal."""
    import torch
    from paddle_tpu_torch.quant import kernels as QK
    alone = {i: QK._launch(x[i:i + 1], q, scales, WEIGHT_BLOCK)[0]
             for i in (0, 5, 37)}
    for t in MOE_TOKENS:
        packed = QK._launch(x[:t], q, scales, WEIGHT_BLOCK)
        for i, y in alone.items():
            if i < t and not torch.equal(y, packed[i]):
                fail(f"dequant {label}: row {i} alone differs from the same "
                     f"row among {t - 1} others")
    print(f"dequant row check ({label}): rows 0, 5 and 37 alone == among 7 "
          "and 63 others, bitwise", flush=True)


def check_packing(mlp, x, label):
    """Tokens 0, 5 and 37 of ``x [64, D]`` through ``mlp`` alone, and
    packed in the first 8 (a decode-only dispatch) and in all 64 (a full
    mixed one): bitwise equal outputs."""
    import torch
    with torch.no_grad():
        alone = {i: mlp(x[i:i + 1])[0] for i in (0, 5, 37)}
        for t in MOE_TOKENS:
            packed = mlp(x[:t])
            for i, y in alone.items():
                if i < t and not torch.equal(y, packed[i]):
                    fail(f"{label} MoE FFN: token {i} alone differs from "
                         f"the same token packed among {t - 1} others")
    print(f"moe packing check ({label}): tokens 0, 5 and 37 alone == packed "
          "among 7 and 63 others, bitwise", flush=True)


def check_moe_kernels(dev):
    """Phase 3c: the grouped GEMMs (bf16 and int8 weights, the bf16 one's
    dx too) and the dequant matmul against their plain versions at
    Mixtral-8x7B serving shapes, on the weights of one Mixtral-width
    ``LlamaMoEMLP`` and the rows its router gives; the packing check.
    Returns the three kernels' JSON entries (without ``launches``),
    their times those of the full mixed dispatch (64 tokens; gate/up
    shape for the grouped GEMMs, q/o shape for the dequant matmul)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaMoEMLP,
                                               router_logits)
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.quant.format import dequant_blocks, quantize_weight
    cfg = LlamaConfig(**MIXTRAL)
    d, f = cfg.hidden_size, cfg.intermediate_size
    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(5)
    mlp = LlamaMoEMLP(cfg, device=dev, dtype=bf)
    mlp.reset_parameters(cfg.initializer_range, g)
    xs = {t: torch.randn(t, d, device=dev, dtype=bf, generator=g)
          for t in MOE_TOKENS}
    hs = {t: torch.randn(8 * t, f, device=dev, dtype=bf, generator=g)
          for t in MOE_TOKENS}
    routed = {}
    for t in MOE_TOKENS:
        slot, *_, gs = mlp.route(xs[t])
        routed[t] = (xs[t][slot.clamp_min(0)], gs)
    edge = {"empty experts": torch.tensor([3, 0, 5, 0, 2, 1, 4, 1],
                                          device=dev),
            "gs > C": torch.tensor([12, 8, 0, 9, 1, 0, 30, 2], device=dev)}
    res = {"float": {}, "q8": {}}

    def shapes(kind, wu, wd, su=None, sd=None, lu=None, ld=None):
        errs = []
        for t in MOE_TOKENS:
            xg, gs = routed[t]
            for name, x, w, s, lib in (("gate/up", xg, wu, su, lu),
                                       ("down", hs[t], wd, sd, ld)):
                r = grouped_case(f"{kind} {name} T={t}", kind, x, w, gs, s,
                                 lib)
                res[kind][(name, t)] = r
                errs.append(r["max_abs_err"])
        for label, gs in edge.items():
            r = grouped_case(f"{kind} gate/up T=8 {label}", kind,
                             routed[8][0], wu, gs, su, timed=False)
            errs.append(r["max_abs_err"])
        return max(errs)

    err_f = shapes("float", mlp.gate_proj.detach(), mlp.down_proj.detach(),
                   lu=mlp.gate_proj.detach(), ld=mlp.down_proj.detach())
    # dx through the Function's backward (the kernel on w transposed,
    # read in place), dw the plain masked product by construction
    xg, gs = routed[64]
    xg = xg.detach().requires_grad_()
    w = mlp.gate_proj.detach().clone().requires_grad_()
    gy = torch.randn(xg.shape[0], f, device=dev, dtype=bf, generator=g)
    with torch.enable_grad():
        GG.grouped_gemm(xg, w, gs).backward(gy)
    wt = w.detach().transpose(1, 2)
    dx_ref = GG.grouped_gemm_ref(gy, wt, gs)
    torch.cuda.synchronize()
    err_dx = check_close("float dx T=64: (row, column)", xg.grad, dx_ref)
    if not torch.equal(w.grad, GG.grouped_gemm_dw(xg.detach(), gy, gs, bf)):
        fail("grouped GEMM dw differs from the plain masked product")
    dx_ms = time_ms(lambda: GG._launch_float(gy, wt, gs))
    dx_dev = device_ms(lambda: GG._launch_float(gy, wt, gs))
    gm = masked_rows(gy, gs)
    dx_lib = device_ms(lambda: torch.bmm(gm, wt))
    dx_bound, dx_by = moe_bound(gs, 64, f, d, 2)
    print(f"moe kernel check (float dx T=64): out_err={err_dx:.3e} "
          f"dw_bitwise=True ms={dx_ms:.4f} device_ms={dx_dev:.4f} "
          f"library_device_ms={dx_lib:.4f} bound_ms={dx_bound:.5f} "
          f"({dx_by})", flush=True)
    del gm
    del xg, w, gy, wt, dx_ref
    check_packing(mlp.eval(), xs[64], "bf16")
    # what the router's fixed order costs against one library product
    for t in MOE_TOKENS:
        x2d = xs[t].float()
        fixed = time_ms(lambda: router_logits(x2d, mlp.gate))
        lib = time_ms(lambda: (x2d.double() @ mlp.gate.double()).float())
        print(f"moe router (T={t}): fixed-order ms={fixed:.4f} library f64 "
              f"product ms={lib:.4f}", flush=True)

    mlp.quantize_weights(WEIGHT_BLOCK)
    lib_u = dequant_blocks(mlp.gate_proj, mlp.gate_proj_scale,
                          WEIGHT_BLOCK).to(bf)
    lib_d = dequant_blocks(mlp.down_proj, mlp.down_proj_scale,
                          WEIGHT_BLOCK).to(bf)
    err_q = shapes("q8", mlp.gate_proj, mlp.down_proj, mlp.gate_proj_scale,
                   mlp.down_proj_scale, lib_u, lib_d)
    del lib_u, lib_d
    check_packing(mlp, xs[64], "int8")

    dq, err_dq = {}, 0.0
    for n in (4096, 1024):            # q and o; k and v
        w = torch.randn(d, n, device=dev, generator=g) * 0.02
        q, s = quantize_weight(w, WEIGHT_BLOCK)
        w_lib = dequant_blocks(q, s, WEIGHT_BLOCK).t().contiguous().to(bf)
        for t in MOE_TOKENS:
            dq[(n, t)] = dequant_case(f"N={n} T={t}", xs[t], q, s, w_lib)
            err_dq = max(err_dq, dq[(n, t)]["max_abs_err"])
        check_dequant_rows(xs[64], q, s, f"N={n}")
    timing = ("ms", "device_ms", "plain_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_by")
    return [dict(name="grouped_gemm", route="cuda", source=GG_SOURCE,
                 replaces="paddle_tpu/ops/grouped_gemm.py:175",
                 max_abs_err=max(err_f, err_dx),
                 **{k: res["float"][("gate/up", 64)][k] for k in timing}),
            dict(name="grouped_gemm_q8", route="cuda", source=GG_SOURCE,
                 replaces="paddle_tpu/ops/grouped_gemm.py:405",
                 max_abs_err=err_q,
                 **{k: res["q8"][("gate/up", 64)][k] for k in timing}),
            dict(name="dequant_matmul", route="cuda",
                 source="paddle_tpu_torch/csrc/dequant_matmul.cu",
                 replaces="paddle_tpu/quant/kernels.py:132",
                 max_abs_err=err_dq,
                 **{k: dq[(4096, 64)][k] for k in timing},
                 decode_t8={k: dq[(4096, 8)][k] for k in timing})]


# phase 3c: the GEMM family at points of the reference's domain past the
# serving shapes: label -> (kernel, x dtype, E, C (M for the dequant
# matmul), K, N, block, timed). Each runs the instance ``gemm_instance``
# names: the general one (C6), but for the grouped GEMMs' f16 points,
# which their cluster instances take (CLUSTER_POINTS). A timed point goes
# through dequant_case or grouped_case (a "q8" one at WEIGHT_BLOCK, the
# block grouped_case takes).
CLUSTER_POINTS = ("#7 f16 x", "#6 f16 x", "#6 f16 x Mixtral gate/up")
GEMM_DOMAIN = {
    "#7 f16 x": ("q8", "float16", 8, 8, 4096, 1024, WEIGHT_BLOCK, True),
    "#6 f16 x Mixtral gate/up": ("float", "float16", 8, 8, 4096, 14336, None,
                                 True),
    "#8 B=24": ("dq", "bfloat16", 1, 8, 4096, 4096, 24, True),
    "#8 B=8": ("dq", "bfloat16", 1, 9, 96, 64, 8, False),
    "#8 N=24 K=40": ("dq", "bfloat16", 1, 70, 40, 24, 40, False),
    "#8 f32 K=37 N=29": ("dq", "float32", 1, 3, 37, 29, 16, False),
    "#6 f16 x": ("float", "float16", 3, 8, 64, 48, None, False),
    "#6 K=40 N=20": ("float", "bfloat16", 3, 8, 40, 20, None, False),
    "#7 B=24": ("q8", "bfloat16", 3, 8, 96, 64, 24, False),
    "#7 N=24 B=8": ("q8", "bfloat16", 3, 8, 40, 24, 8, False),
    "#7 f32 K=37 N=29": ("q8", "float32", 3, 8, 37, 29, 16, False),
}


def check_gemm_domain(dev):
    """Phase 3c, C6: the grouped GEMMs and the dequant matmul at
    GEMM_DOMAIN's points (f16 x, blocks of 8, 24 and 40, N 24, K and N
    off multiples of 8): each launches the instance ``gemm_instance``
    names (the general one but at CLUSTER_POINTS) and stays within phase 3's
    bound of its plain version; the timed points also get phase 3c's
    times, bound and library time. Returns the largest error of each
    kernel by its JSON name."""
    import torch
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    from paddle_tpu_torch.quant import kernels as QK
    from paddle_tpu_torch.quant.format import dequant_blocks, quantize_weight
    g = torch.Generator(dev).manual_seed(7)
    errs = {"grouped_gemm": 0.0, "grouped_gemm_q8": 0.0,
            "dequant_matmul": 0.0}
    for label, (kind, dtype, e, c, k, n, block, timed) in GEMM_DOMAIN.items():
        dt = getattr(torch, dtype)
        w = torch.randn(e, k, n, device=dev, generator=g) * 0.05
        x = torch.randn(e * c, k, device=dev, generator=g).to(dt)
        gs = torch.tensor([c, 0, c + 2, 1, c - 1, 3, 0, c][:e],
                          dtype=torch.int32, device=dev)
        if kind == "dq":
            name, counts = "dequant_matmul", QK.instance_launches
            q, s = quantize_weight(w[0], block)

            def run():
                return QK._launch(x, q, s, block)

            def plain():
                return QK.dequant_matmul_ref(x, q, s, block)
        elif kind == "q8":
            name, counts = "grouped_gemm_q8", GG.instance_launches
            q, s = quantize_weight(w, block)

            def run():
                return GG._launch_q8(x, q, s, gs, block)

            def plain():
                return GG.grouped_gemm_q8_ref(x, q, s, gs, block)
        else:
            name, counts = "grouped_gemm", GG.instance_launches
            wt = w.to(dt)

            def run():
                return GG._launch_float(x, wt, gs)

            def plain():
                return GG.grouped_gemm_ref(x, wt, gs)
        inst = gemm_instance(name, dt, k, n, block and min(block, k))
        key = f"{name}.{inst}"
        before = counts[key]
        tag = f"gemm domain {label}"
        if timed and kind == "dq":
            lib = dequant_blocks(q, s, block).t().contiguous().to(dt)
            err = dequant_case(tag, x, q, s, lib, block)["max_abs_err"]
        elif timed and kind == "float":
            err = grouped_case(tag, kind, x, wt, gs, w_lib=wt)["max_abs_err"]
        elif timed:
            lib = dequant_blocks(q, s, block).to(dt)
            err = grouped_case(tag, kind, x, q, gs, s, lib)["max_abs_err"]
        else:
            y, ref = run(), plain()
            torch.cuda.synchronize()
            err = check_close(tag, y, ref)
            print(f"gemm domain check ({label}): E={e} C={c} K={k} N={n} "
                  f"B={block} {dtype} instance={key} out_err={err:.3e}",
                  flush=True)
        want = "cluster" if label in CLUSTER_POINTS else "general"
        if inst != want or counts[key] == before:
            fail(f"{tag}: ran {key}, not the {want} instance")
        errs[name] = max(errs[name], err)
    return errs


def mixtral_int8(dev):
    """Mixtral-8x7B at full width and depth with int8 weights: a 0-layer
    model on the card, then each of the 32 layers made on ``meta``,
    moved to the card, initialised from one seeded generator and
    quantized before the next exists (a bf16 layer is ~2.9 GB; the whole
    bf16 model, 93 GB, would not fit)."""
    import torch
    from torch import nn
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaDecoderLayer,
                                               LlamaForCausalLM, LlamaMoEMLP,
                                               RMSNorm)
    from paddle_tpu_torch.quant import quantize_model
    cfg = LlamaConfig(**MIXTRAL)
    std = cfg.initializer_range
    gen = torch.Generator(dev).manual_seed(0)
    model = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=0),
                             device=dev, dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for _ in range(cfg.num_hidden_layers):
            layer = LlamaDecoderLayer(cfg, device="meta",
                                      dtype=torch.bfloat16)
            layer.to_empty(device=dev)
            for mod in layer.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.normal_(0.0, std, generator=gen)
                elif isinstance(mod, RMSNorm):
                    mod.weight.fill_(1.0)
                elif isinstance(mod, LlamaMoEMLP):
                    mod.reset_parameters(std, gen)
            model.model.layers.append(quantize_model(layer))
    model.config = model.model.config = cfg
    return model.eval()


@contextlib.contextmanager
def plain_serving_paths():
    """Route the grouped GEMMs, the dequant matmul and the no-cache
    forward's attention to their plain versions (the token check)."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.quant import kernels as QK
    saved = (GG._launch_float, GG._launch_q8, QK._launch,
             llama.causal_attention)
    GG._launch_float, GG._launch_q8 = GG.grouped_gemm_ref, \
        GG.grouped_gemm_q8_ref
    QK._launch = QK.dequant_matmul_ref
    llama.causal_attention = llama.plain_attention
    try:
        yield
    finally:
        (GG._launch_float, GG._launch_q8, QK._launch,
         llama.causal_attention) = saved


def kernel_launches():
    """The launch counters of the serving path's kernels."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    return dict(**{f"attention {k}": n for k, n in rpa.launches.items()},
                dequant_matmul=QK.launches, **GG.launches)


@contextlib.contextmanager
def route_taps(taps):
    """Tap each MoE layer's expert choices (``[n, k]``) into ``taps``."""
    from paddle_tpu_torch.models.llama import LlamaMoEMLP
    route = LlamaMoEMLP.route

    def tapped(self, x2d):
        out = route(self, x2d)
        taps.tap("route", out[1])
        return out
    LlamaMoEMLP.route = tapped
    try:
        yield
    finally:
        LlamaMoEMLP.route = route


def route_choices(records, layers):
    """``choices(req, n)``: the ``[L, n, k]`` experts the engine chose at
    positions ``0..n-1`` of ``req``, from the route taps of ``records``
    (:func:`tick_taps`; a tick's choices hold its padding rows past the
    live ones, and a row that retired mid-scan runs on past ``n``)."""
    import torch

    def choices(req, n):
        k = next(tags["route"][0].shape[1] for _, tags in records
                 if tags.get("route"))
        out = None
        for rows, tags in records:
            picks = tags.get("route")
            if not picks:
                continue
            if out is None:
                out = torch.full((layers, n, k), -1, dtype=torch.long,
                                 device=picks[0].device)
            t = 0
            for r, start, m in rows:
                if r is req and start < n:
                    m2 = min(m, n - start)
                    for li in range(layers):
                        out[li, start:start + m2] = picks[li][t:t + m2]
                t += m
        if out is None or bool((out < 0).any()):
            fail("a position of a served request was never routed")
        return out
    return choices


@contextlib.contextmanager
def replayed_routes(model, stats):
    """Make every ``LlamaMoEMLP`` of ``model`` take the experts in
    ``stats["choices"]`` (``[L, n, k]``, set per forward) instead of its
    own top-k, with the weights its own softmax gives them; record in
    ``stats`` how far each replayed choice is from the plain router's
    own top-k (router logit of its k-th choice minus the smallest
    replayed one's, per route) and, per layer, how many routes there
    were and how many differ."""
    import torch
    from paddle_tpu_torch.incubate.moe import top_k_routing
    from paddle_tpu_torch.models.llama import LlamaMoEMLP, router_logits
    layer_of = {id(layer.mlp): i for i, layer in enumerate(model.model.layers)}
    route = LlamaMoEMLP.route

    def replay(self, x2d):
        n, e, k = x2d.shape[0], self.num_experts, self.top_k
        chosen = stats["choices"][layer_of[id(self)]]
        logits = router_logits(x2d, self.gate)
        probs = torch.softmax(logits, dim=-1)
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            1, chosen, True)
        out = list(top_k_routing(logits.masked_fill(~keep, float("-inf")),
                                 k, n))
        picked = probs.gather(1, out[1])
        out[4] = picked / (picked.sum(dim=-1, keepdim=True) + 1e-9)
        own = torch.sort(logits, dim=-1, descending=True, stable=True)
        deficit = own.values[:, k - 1] - logits.gather(1, out[1]).min(-1).values
        li = layer_of[id(self)]
        stats["deficits"][li].append(deficit)
        stats["flips"][li] += int((own.indices[:, :k].sort(dim=-1).values
                                   != out[1].sort(dim=-1).values).any(-1).sum())
        stats["routes"][li] += n
        gs = ((out[1].reshape(-1, 1) == torch.arange(e, device=x2d.device))
              & out[3].reshape(-1, 1)).sum(dim=0, dtype=torch.int32)
        return tuple(out) + (gs,)
    LlamaMoEMLP.route = replay
    try:
        yield
    finally:
        LlamaMoEMLP.route = route


def moe_run(engine, model, prompts, label, per_layer):
    """One run of phase 4's requests through ``engine.generate`` with its
    dispatches and ticks tapped (finite logits, expert choices), every
    kernel launch counted (``per_layer`` a layer a dispatch or tick; the
    attention kernel's two always) and no plain version called. Returns
    (reqs, outs, wall, launches, dispatches, ticks, times, choices)."""
    import torch
    from paddle_tpu_torch.inference import Request
    layers = model.config.num_hidden_layers
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    with tick_taps(engine) as taps, finite_taps(model, taps), \
            route_taps(taps):
        warm_up(engine, prompts)
        n0 = len(taps.records)
        reset_launches()
        torch.cuda.synchronize()
        with count_calls(serving_plain_versions()) as plain_calls, \
                timed_dispatches(engine) as times:
            t0 = time.perf_counter()
            outs = engine.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
    records = taps.records[n0:]
    ticks = sum(times["ticks"].values())
    dispatches = len(times["mixed"]) + len(times["decode"])
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    want = {k: per_layer.get(k, 0) * layers * (dispatches + ticks)
            for k in launches}
    want["attention fused_rope"] = 2 * layers * (dispatches + ticks)
    if launches != want or not dispatches:
        fail(f"{label}: kernel launches {launches} != {want} "
             f"({dispatches} dispatches, {ticks} ticks)")
    if not all_finite(records):
        fail(f"{label}: non-finite logits in the serving run")
    for o in outs:
        if len(o) != NEW or not all(0 <= t < model.config.vocab_size
                                    for t in o):
            fail(f"{label}: bad output {o}")
    return (reqs, outs, wall, launches, dispatches, ticks, times,
            route_choices(records, layers))


def serve_moe(dev, label, model, weight_dtype, per_layer):
    """Phases 6 and 7: serve phase 4's prompts through
    ``LlamaServingEngine(max_batch=8, page_size=16, weight_dtype=...)``
    twice: graphed (decode scans replaying the tick graph) and with
    ``decode_ticks=1`` (single mixed steps), every kernel launch counted
    (``per_layer``: launches of each kernel per layer per dispatch or
    tick; the attention kernel's two always) and no plain version called;
    then every token of the graphed run against the model's own forward
    through the plain versions, and the share equal to the single-step
    run's printed.

    Routing is discontinuous: two paths whose sums round differently
    pick different experts where the router's top-k is a near-tie, and
    on random weights at full depth those flips cascade (the first chip
    run matched 36/256 tokens this way). So the plain forward replays
    the experts the engine chose at every (position, layer), recorded
    from its dispatches and, after every replay, from the tick graph's
    own routing tensors, with the weights its own router gives them. The
    paths drift apart with depth as the dense model's do (phase 4's
    logits), and the replayed choices drift from the plain router's own
    top-k with them: the line prints how often and how far, per quarter
    of the layers. At layer 0 the two paths' router inputs differ only by
    the rounding of the attention and projection kernels, so there every
    replayed choice must be within ROUTE_TOL router logits of the plain
    top-k: an engine that routed wrongly would fail there, or in the
    token check. A second graphed run's scans are counted by the
    profiler, a window a scan, and held against the wrappers'. Returns
    the launches of both runs."""
    import torch
    from paddle_tpu_torch.inference import Request
    cfg = model.config
    layers = cfg.num_hidden_layers
    prompts = serving_prompts(cfg.vocab_size)
    runs = {}
    for name, ticks in (("single", 1), ("graphed", None)):
        engine = serving_engine(model, weight_dtype=weight_dtype,
                                decode_ticks=ticks)
        torch.cuda.reset_peak_memory_stats()
        runs[name] = moe_run(engine, model, prompts, f"{label} {name}",
                             per_layer)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if name == "graphed":
            # the profiler's count of a second run's replays, a window a
            # scan, held against the wrappers' count
            with timed_dispatches(engine) as ptimes, \
                    profiled_scans(engine) as (prof, py):
                engine.generate([Request(p, max_new_tokens=NEW)
                                 for p in prompts])
            p_ticks = sum(ptimes["ticks"].values())
        del engine
        torch.cuda.empty_cache()
    reqs, outs, wall, launches, dispatches, ticks, times, choices = \
        runs["graphed"]
    sreqs, souts, swall, slaunches, sdisp, _, stimes, _ = runs["single"]
    replay = [choices(r, len(p) + NEW - 1) for r, p in zip(reqs, prompts)]
    gaps = []
    stats = dict(deficits=[[] for _ in range(layers)], flips=[0] * layers,
                 routes=[0] * layers)
    with plain_serving_paths(), replayed_routes(model, stats):
        before = kernel_launches()
        for p, o, chosen in zip(prompts, outs, replay):
            stats["choices"] = chosen
            ids = torch.tensor([p + o[:-1]], device=dev)
            with torch.no_grad():
                lg = model(ids)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
        torch.cuda.synchronize()
        if kernel_launches() != before:
            fail(f"{label}: the plain check launched a kernel")
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    deficits = [float(torch.cat(d).max()) for d in stats["deficits"]]
    quarter = max(1, layers // 4)
    flips = [f"{sum(stats['flips'][i:i + quarter])}/"
             f"{sum(stats['routes'][i:i + quarter])}"
             for i in range(0, layers, quarter)]
    worst_route = [round(max(deficits[i:i + quarter]), 4)
                   for i in range(0, layers, quarter)]
    n_tok = len(prompts) * NEW
    eq = sum(a == b for o, ob in zip(outs, souts) for a, b in zip(o, ob))
    print(f"serve {label} graphed: layers={layers} requests={len(prompts)} "
          f"prompt_tokens={sum(map(len, prompts))} new_tokens={n_tok} "
          f"{run_line(reqs, wall, dispatches, ticks, times)} "
          f"launches={launches} peak_mem_gb={peak:.2f} plain_forward_exact="
          f"{exact}/{n_tok} worst_gap={worst:.4f} gap_p90="
          f"{float(gaps.quantile(0.9)):.4f} equal_to_single_steps={eq}/"
          f"{n_tok} route_flips_by_layer_quarter={flips} route_deficit_max_"
          f"by_layer_quarter={worst_route} layer0_route_flips="
          f"{stats['flips'][0]}/{stats['routes'][0]} layer0_route_deficit="
          f"{deficits[0]:.4f}", flush=True)
    print(f"serve {label} single steps (decode_ticks=1): "
          f"{run_line(sreqs, swall, sdisp, 0, stimes)} launches={slaunches}",
          flush=True)
    print(f"serve {label} graphed, profiler over a second run's scans (a "
          f"window a scan, {p_ticks} ticks): launches {dict(prof)}, the "
          f"wrappers' {dict(py)}", flush=True)
    hold_profiled(f"{label} graphed, profiled scans", prof, py)
    if not p_ticks or prof.get("attention") != layers * p_ticks:
        fail(f"{label} graphed, profiled scans: {dict(prof)} for {p_ticks} "
             "ticks")
    if deficits[0] > ROUTE_TOL:
        fail(f"{label}: at layer 0 an expert the engine chose is "
             f"{deficits[0]:.3f} router logits below the plain router's "
             f"top-{cfg.moe_top_k} (tol {ROUTE_TOL})")
    if exact < EXACT_FLOOR * n_tok:
        fail(f"{label}: only {exact}/{n_tok} served tokens are the plain "
             f"forward's argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"{label}: served token {worst:.3f} below the plain forward's "
             "argmax")
    return {k: launches[k] + slaunches[k] for k in launches}


def serve_mixtral_int8(dev):
    """Phase 6: Mixtral-8x7B, int8 weights, 32 layers, one card."""
    import torch
    from paddle_tpu_torch.quant import serving_weight_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mixtral_int8(dev)
    torch.cuda.synchronize()
    actual, baseline, _ = serving_weight_bytes(model)
    print(f"model: mixtral_8x7b int8 layers={model.config.num_hidden_layers}"
          f" init_s={time.perf_counter() - t0:.1f} weight_bytes="
          f"{actual} bf16_baseline_bytes={baseline} build_peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)
    return serve_moe(dev, "mixtral int8", model, "int8",
                     {"dequant_matmul": 4, "grouped_gemm_q8": 3})


def serve_mixtral_bf16(dev):
    """Phase 7: the bf16 MoE FFN, Mixtral-8x7B width, 4 layers."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig(**MIXTRAL),
                              num_hidden_layers=FLOAT_MOE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: mixtral_8x7b bf16 layers={FLOAT_MOE_LAYERS} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    launches = serve_moe(dev, "mixtral bf16", model.eval(), None,
                         {"grouped_gemm": 3})
    # phase 4b on this cut: #6 under capture, then, the model quantized in
    # place by the engine, #7 and #8
    prompts = serving_prompts(cfg.vocab_size)
    check_tick_replay(serving_engine(model), "mixtral bf16", prompts)
    torch.cuda.empty_cache()
    check_tick_replay(serving_engine(model, weight_dtype="int8"),
                      "mixtral int8 (4 layers)", prompts)
    return launches


# ----------------------------------------------------------------------
# the sampler: phases 3g, 11, 12
# ----------------------------------------------------------------------

def sampler_rows(dev, n, v, seed):
    """``n`` rows of the sampler's per-row arrays at vocabulary ``v``,
    greedy, top-k 50, top-p 0.9 and constrained rows in turn, seeded
    logits ``[n, v]`` (std 3) on the card. Returns (logits, arrays)."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    logits = torch.randn((n, v), device=dev, generator=g) * 3
    kind = torch.arange(n, device=dev) % 4
    temps = torch.where(kind == 0, 0.0, torch.where(kind == 2, 0.8, 1.0))
    top_ps = torch.where(kind == 2, 0.9, 1.0)
    top_ks = torch.where(kind == 1, 50, 0).int()
    seeds = torch.randint(0, 2 ** 31, (n,), device=dev, generator=g).int()
    positions = torch.randint(0, 8192, (n,), device=dev, generator=g).int()
    slot_ids = torch.full((n, 8), -1, dtype=torch.int32, device=dev)
    slot_ids[kind == 3] = torch.tensor(ALLOWED, dtype=torch.int32,
                                       device=dev)
    slot_vals = torch.zeros((n, 8), device=dev)
    cmodes = (kind == 3).int()
    return logits, (temps, top_ps, top_ks, seeds, positions, slot_ids,
                    slot_vals, cmodes)


def sampler_bound(n, v):
    """(ms, "bytes" | "operations"): the scores read once (and the per-row
    operands) against GUMBEL_INT_OPS integer operations an element."""
    nbytes = n * v * 4 + n * (4 + 4 + 8 + 4 + 8)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = GUMBEL_INT_OPS * n * v / INT32_OPS * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes \
        else (by_bytes, "bytes")


def check_sampler(dev):
    """Phase 3g: ``gumbel_argmax`` / ``gumbel_noise`` against the plain
    version at the sampler's shapes. Returns the JSON entry (without
    ``launches``), timed at 8 rows of Llama-3's vocabulary."""
    import torch
    from paddle_tpu_torch.inference.sampling import (biased_logits,
                                                     scaled_scores)
    from paddle_tpu_torch.ops import sampling as SM
    entry, g_err = None, 0.0
    for name, v in SAMPLER_VOCABS.items():
        for n in SAMPLER_ROWS:
            label = f"gumbel {name} n={n}"
            logits, arrays = sampler_rows(dev, n, v, seed=n + v)
            temps, top_ps, top_ks, seeds, positions, slot_ids, slot_vals, \
                cmodes = arrays
            ls, thr = scaled_scores(
                biased_logits(logits, slot_ids, slot_vals, cmodes), temps,
                top_ps, top_ks)
            bases = torch.zeros(n, dtype=torch.int64, device=dev)
            args = (ls, seeds, positions, bases, thr)
            with count_calls([(SM, "gumbel_argmax_ref"),
                              (SM, "gumbel_noise_ref")]) as plain_calls:
                l0 = dict(SM.launches)
                bits, u, g = SM.gumbel_noise(seeds, positions, bases, v)
                got = SM.gumbel_argmax(*args)
                torch.cuda.synchronize()
            if plain_calls or SM.launches["gumbel_noise"] != \
                    l0["gumbel_noise"] + 1 or SM.launches["gumbel_argmax"] \
                    != l0["gumbel_argmax"] + 1:
                fail(f"{label}: launches {SM.launches} from {l0}, plain "
                     f"calls {plain_calls}")
            rb, ru, rg = SM.gumbel_noise_ref(seeds, positions, bases, v)
            if not torch.equal(bits, rb) or not torch.equal(
                    u.view(torch.int32), ru.view(torch.int32)):
                fail(f"{label}: bits or uniforms differ from the plain "
                     "version's")
            rel = float(((g - rg).abs() / rg.abs().clamp_min(1.0)).max())
            g_err = max(g_err, float((g - rg).abs().max()))
            if rel > SM.GUMBEL_REL:
                fail(f"{label}: g off by {rel:.3e} (tol {SM.GUMBEL_REL})")
            z = SM.perturbed_scores(*args)
            want = z.argmax(dim=-1)
            tol = 2 * SM.GUMBEL_REL * 17.0
            for i in torch.nonzero(got != want)[:, 0].tolist():
                margin = float(z[i, want[i]] - z[i, got[i]])
                print(f"{label}: row {i} token {int(got[i])} vs plain "
                      f"{int(want[i])}, margin {margin:.3e}", flush=True)
                if not 0.0 <= margin <= tol + 1e-5 * float(z[i, want[i]]
                                                           .abs()):
                    fail(f"{label}: row {i} differs beyond the tolerance")
            if not all(int(t) in ALLOWED for t in got[cmodes == 1]):
                fail(f"{label}: a constrained row left its allowed set")
            ms = time_ms(lambda: SM.gumbel_argmax(*args))
            dev_ms = device_ms(lambda: SM.gumbel_argmax(*args))
            plain_ms = time_ms(lambda: SM.gumbel_argmax_ref(*args), iters=5,
                               warmup=1)
            sort_ms = time_ms(lambda: torch.sort(ls, dim=-1,
                                                 descending=True))
            bound_ms, bound_by = sampler_bound(n, v)
            print(f"kernel check ({label}): rows={n} vocab={v} bits and u "
                  f"bitwise, g_rel_err={rel:.3e} (tol {SM.GUMBEL_REL:.3e}) "
                  f"tokens_equal={int((got == want).sum())}/{n} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
                  f"sort_ms={sort_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"({bound_by})", flush=True)
            if entry is None:
                entry = dict(name="gumbel_argmax", route="cuda",
                             source=SM_SOURCE, replaces=SM_REPLACES, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             sort_ms=sort_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
    entry["max_abs_err"] = g_err
    return entry


@contextlib.contextmanager
def sampled_dispatches(engine):
    """Count ``engine``'s dispatches that hold a sampled row and the
    ``gumbel_argmax`` launches and sorts of each: yields a list of
    ``(sampled, launches, sorts)``, one per dispatch."""
    import torch
    from paddle_tpu_torch.ops import sampling as SM
    seen, sorts = [], []
    real_sort, dispatch = torch.sort, engine._dispatch_rows

    def counted_sort(*a, **k):
        sorts.append(1)
        return real_sort(*a, **k)

    def wrapper(rows, cow=()):
        sampled = any(r.sampling is not None and r.sampling.temperature > 0
                      for r, *_ in rows)
        l0, s0 = SM.launches["gumbel_argmax"], len(sorts)
        out = dispatch(rows, cow)
        seen.append((sampled, SM.launches["gumbel_argmax"] - l0,
                     len(sorts) - s0))
        return out
    torch.sort, engine._dispatch_rows = counted_sort, wrapper
    try:
        yield seen
    finally:
        torch.sort, engine._dispatch_rows = real_sort, dispatch


def sampled_requests(prompts, kinds=SAMPLED_ROWS):
    """Phase 11's requests over phase 4's prompts (``kinds``, by default
    SAMPLED_ROWS), each sampled one with its own fixed seed."""
    from paddle_tpu_torch.inference import Request, SamplingParams
    reqs = []
    for i, (p, kind) in enumerate(zip(prompts, kinds)):
        if kind is None:
            sp = None
        elif kind == "forced":
            sp = SamplingParams(temperature=1.0, seed=1000 + i,
                                logit_bias={FORCED_TOKEN: 1e9})
        elif kind == "constrained":
            sp = SamplingParams(temperature=1.0, seed=1000 + i,
                                constraint=lambda a, b: ALLOWED)
        else:
            sp = SamplingParams(seed=1000 + i, **kind)
        reqs.append(Request(p, max_new_tokens=NEW, sampling=sp))
    return reqs


def replay_sampled(engine, model, dev, req, out):
    """Replay one sampled request: the model's plain forward over its
    prompt and tokens, then the plain sampler at each emitted token's
    (seed, position) with the rows the engine packs. Returns (tokens,
    ``(position, margin, replay token's and served token's scaled logit
    over the replay's keep threshold)`` where they differ: a token near a
    top-k or top-p boundary can be kept by one side only)."""
    import torch
    from paddle_tpu_torch.inference.sampling import (biased_logits,
                                                     scaled_scores)
    from paddle_tpu_torch.ops import sampling as SM
    p = list(req.prompt_ids)
    ids = torch.tensor([p + out[:-1]], device=dev)
    with torch.no_grad():
        lg = model(ids)[0, len(p) - 1:].float()
    rows = [(req, req.seq_id, len(p) + j - 1, 1, (0,), True)
            for j in range(len(out))]
    arrays, _ = engine._sample_arrays(rows)
    temps, top_ps, top_ks, seeds, positions, slot_ids, slot_vals, cmodes = \
        [torch.from_numpy(a).to(dev) for a in arrays]
    ls, thr = scaled_scores(biased_logits(lg, slot_ids, slot_vals, cmodes),
                            temps, top_ps, top_ks)
    bases = torch.zeros_like(positions, dtype=torch.int64)
    z = SM.perturbed_scores(ls, seeds, positions, bases, thr)
    toks = z.argmax(dim=-1)
    got = torch.tensor(out, device=dev)
    margins = (z.gather(1, toks[:, None]) - z.gather(1, got[:, None]))[:, 0]
    diff = torch.nonzero(toks != got)[:, 0].tolist()
    return toks.tolist(), [(i, float(margins[i]),
                            float(ls[i, toks[i]] - thr[i]),
                            float(ls[i, got[i]] - thr[i])) for i in diff]


def serve_sampled(dev, greedy):
    """Phase 11: phase 4's model and prompts with sampled rows (see the
    module docstring), first with ``decode_ticks=1`` (a constraint hook
    pins the engine to single steps anyway, and each dispatch's launches
    and sorts are counted), then graphed, the constrained row made greedy
    so that the sampled tick graph runs: its greedy rows bitwise phase 4's
    graphed tokens (same schedule, same shapes), the forced row obeying.
    ``greedy``: phase 4's result. Returns the ``gumbel_argmax``
    launches."""
    import torch
    from paddle_tpu_torch.ops import sampling as SM
    cfg, model, engine, prompts = serving_workload(dev, decode_ticks=1)
    runs = []
    for _ in range(2):
        reqs = sampled_requests(prompts)
        with count_calls(serving_plain_versions()
                         + [(SM, "gumbel_argmax_ref")]) as plain_calls, \
                sampled_dispatches(engine) as seen:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = engine.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs.append((reqs, outs, wall, seen, SM.launches["gumbel_argmax"]))
        if plain_calls:
            fail(f"serve sampled: plain versions ran on the card: "
                 f"{sorted(set(plain_calls))}")
    (reqs, outs, wall, seen, launches), second = runs[0], runs[1]
    if second[1] != outs:
        fail("serve sampled: a second run with the same seeds differs")
    for sampled, n_launch, n_sort in seen:
        if (n_launch, n_sort) != ((1, 1) if sampled else (0, 0)):
            fail(f"serve sampled: a dispatch (sampled={sampled}) launched "
                 f"gumbel_argmax {n_launch} times and sorted {n_sort} times")
    n_sampled = sum(s for s, _, _ in seen)
    if launches != n_sampled or not n_sampled:
        fail(f"serve sampled: {launches} launches for {n_sampled} sampled "
             "dispatches")
    kinds = SAMPLED_ROWS
    for i, (kind, o) in enumerate(zip(kinds, outs)):
        if len(o) != NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"serve sampled: bad output {o}")
        if kind is None and o != greedy["single_outs"][i]:
            fail(f"serve sampled: greedy row {i} differs from phase 4's "
                 "single steps'")
        if kind == "forced" and set(o) != {FORCED_TOKEN}:
            fail(f"serve sampled: forced row {i} gave {sorted(set(o))}")
        if kind == "constrained" and not set(o) <= set(ALLOWED):
            fail(f"serve sampled: constrained row {i} left its set: {o}")
    exact, n_tok, diffs = 0, 0, []
    with plain_serving_paths():
        for i, (r, o) in enumerate(zip(reqs, outs)):
            if kinds[i] is None:
                continue
            toks, margins = replay_sampled(engine, model, dev, r, o)
            exact += sum(a == b for a, b in zip(toks, o))
            n_tok += len(o)
            diffs += [(i,) + m for m in margins]
    for i, pos, margin, over_r, over_s in diffs:
        print(f"serve sampled: row {i} token {pos} differs from the plain "
              f"replay, its margin there {margin:.4f} (over the keep "
              f"threshold: replay's token {over_r:.4f}, served "
              f"{over_s:.4f})", flush=True)
    tps = len(prompts) * NEW / wall
    print(f"serve sampled (decode_ticks=1): requests={len(prompts)} "
          f"new_tokens={len(prompts) * NEW} dispatches={len(seen)} "
          f"sampled_dispatches={n_sampled} gumbel_launches={launches} "
          f"wall_s={wall:.3f} tokens_per_s={tps:.1f} (phase 4 single "
          f"steps: {greedy['single_tps']:.1f}) second_run_wall_s="
          f"{second[2]:.3f} plain_replay_exact={exact}/{n_tok}", flush=True)
    if exact < EXACT_FLOOR * n_tok:
        fail(f"serve sampled: only {exact}/{n_tok} sampled tokens are the "
             f"plain replay's (floor {EXACT_FLOOR})")
    # graphed, the constrained row greedy
    del engine
    torch.cuda.empty_cache()
    engine = serving_engine(model)
    warm_up(engine, prompts)
    gkinds = tuple(None if k == "constrained" else k for k in SAMPLED_ROWS)
    with count_calls(serving_plain_versions()
                     + [(SM, "gumbel_argmax_ref")]) as plain_calls, \
            sampled_dispatches(engine) as seen, \
            timed_dispatches(engine) as times:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greqs = sampled_requests(prompts, gkinds)
        gouts = engine.generate(greqs)
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
        glaunches = SM.launches["gumbel_argmax"]
    replays = dict(times["ticks"])
    want = sum(s for s, _, _ in seen) + replays.get("sampled", 0)
    if plain_calls or glaunches != want or not replays.get("sampled"):
        fail(f"serve sampled graphed: {glaunches} gumbel_argmax launches "
             f"(want {want}: sampled dispatches and sampled ticks {replays})"
             f", plain calls {plain_calls}")
    for i, (kind, o) in enumerate(zip(gkinds, gouts)):
        if kind is None and o != greedy["outs"][i]:
            fail(f"serve sampled graphed: greedy row {i} differs from phase "
                 "4's graphed tokens")
        if kind == "forced" and set(o) != {FORCED_TOKEN}:
            fail(f"serve sampled graphed: forced row {i} gave "
                 f"{sorted(set(o))}")
    # the sampled tick's rows (a sampler position or seed wrong in the
    # tick would show here) against the plain forward and plain sampler
    gexact, gn_tok = 0, 0
    with plain_serving_paths():
        for i, (r, o) in enumerate(zip(greqs, gouts)):
            if gkinds[i] is None:
                continue
            toks, margins = replay_sampled(engine, model, dev, r, o)
            gexact += sum(a == b for a, b in zip(toks, o))
            gn_tok += len(o)
            for pos, margin, over_r, over_s in margins:
                print(f"serve sampled graphed: row {i} token {pos} differs "
                      f"from the plain replay, its margin there "
                      f"{margin:.4f} (over the keep threshold: replay's "
                      f"token {over_r:.4f}, served {over_s:.4f})",
                      flush=True)
    print(f"serve sampled graphed (row 7 greedy): dispatches={len(seen)} "
          f"ticks={replays} gumbel_launches={glaunches} wall_s={gwall:.3f} "
          f"tokens_per_s={len(prompts) * NEW / gwall:.1f} (phase 4 graphed: "
          f"{greedy['tps']:.1f}) plain_replay_exact={gexact}/{gn_tok}; "
          "greedy rows bitwise phase 4's graphed tokens, the forced row "
          "obeys", flush=True)
    if gexact < EXACT_FLOOR * gn_tok:
        fail(f"serve sampled graphed: only {gexact}/{gn_tok} sampled tokens "
             f"are the plain replay's (floor {EXACT_FLOOR})")
    return launches + second[4] + glaunches


def generate_prompts(vocab):
    import numpy as np
    rng = np.random.RandomState(12)
    return rng.randint(0, vocab, (GEN_PROMPTS, GEN_LEN)).tolist()


def eager_generate(model, ids, new, sampler, seed):
    """``generate``'s decode loop run eagerly, over host ints: the same
    ``_decode_step`` on the same buffer length, no graph."""
    import torch
    b, s = ids.shape
    caches = model._empty_caches(b, ((s + new + 63) // 64) * 64)
    length, tokens, out = 0, ids, []
    with torch.no_grad():
        for i in range(new):
            tokens, length, caches = model._decode_step(
                tokens, length, caches, (seed, i), sampler)
            out.append(tokens)
    return torch.cat([ids.long()] + out, dim=1)


def generate_phase(dev):
    """Phase 12: ``LlamaForCausalLM.generate`` at Llama-3-8B's full width
    and depth (see the module docstring), each sampler warmed up first
    (its step graph captured), then timed, then its decode loop run
    eagerly at the same batch and buffer: tokens bit for bit equal, ms a
    step for both. Returns the ``gumbel_argmax`` launches."""
    import torch
    from paddle_tpu_torch.ops import sampling as SM
    cfg, model = llama_model(dev)
    prompts = generate_prompts(cfg.vocab_size)
    ids = torch.tensor(prompts, device=dev)
    timed = {}
    for name, kw, sampler in (
            ("greedy", {}, (False, None, None, 1.0)),
            ("sampled", dict(do_sample=True, top_k=50, top_p=0.9, seed=1234),
             (True, 50, 0.9, 1.0))):
        with captured_kernels_only(f"generate {name} capture"):
            model.generate(ids, max_new_tokens=GEN_NEW, **kw)
        with count_calls([(SM, "gumbel_argmax_ref")]) as plain_calls:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = SM.launches["gumbel_argmax"]
        want = GEN_NEW if kw else 0
        if plain_calls or launches != want:
            fail(f"generate {name}: {launches} gumbel_argmax launches "
                 f"(want {want}), plain calls {plain_calls}")
        new = out[:, GEN_LEN:]
        if tuple(out.shape) != (GEN_PROMPTS, GEN_LEN + GEN_NEW) or \
                not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            fail(f"generate {name}: bad output {tuple(out.shape)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = eager_generate(model, ids, GEN_NEW, sampler,
                               kw.get("seed", 0))
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
        if not torch.equal(out, eager):
            fail(f"generate {name}: the graphed steps' tokens differ from "
                 f"the eager steps' ({int((out != eager).sum())} of "
                 f"{out.numel()})")
        max_len = (GEN_LEN + GEN_NEW + 63) // 64 * 64
        key, steps = model._decode_state
        if key[1:] != (sampler, GEN_PROMPTS, max_len):
            fail(f"generate {name}: the kept step graph is {key[1:]}")
        _, prof, _ = profiled_launches(lambda: steps.replay("step"))
        _, _, step_ms = profiled_launches(
            lambda: [steps.replay("step") for _ in range(5)])
        print(f"generate {name}: one replay of the step, profiler launches "
              f"{prof}, device_ms per step {step_ms / 5:.3f}", flush=True)
        timed[name] = (new.tolist(), wall, launches, eager_wall)
    engine = serving_engine(model)
    served = engine.generate(prompts, max_new_tokens=GEN_NEW)
    greedy = timed["greedy"][0]
    same = sum(a == b for o, e in zip(greedy, served) for a, b in zip(o, e))
    gaps = []
    with plain_serving_paths():
        for p, o in zip(prompts, greedy):
            seq = torch.tensor([p + o[:-1]], device=dev)
            with torch.no_grad():
                lg = model(seq)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    n_tok = GEN_PROMPTS * GEN_NEW
    ms = {k: (1e3 * v[1] / GEN_NEW, 1e3 * v[3] / GEN_NEW)
          for k, v in timed.items()}
    print(f"generate: prompts={GEN_PROMPTS}x{GEN_LEN} new={GEN_NEW} "
          f"greedy_ms_per_step={ms['greedy'][0]:.2f} (eager "
          f"{ms['greedy'][1]:.2f}) sampled_ms_per_step="
          f"{ms['sampled'][0]:.2f} (eager {ms['sampled'][1]:.2f}) "
          f"graphed_tokens_bitwise_eager=True sampled_gumbel_launches="
          f"{timed['sampled'][2]} greedy_equal_to_engine={same}/{n_tok} "
          f"plain_forward_exact={exact}/{n_tok} worst_gap={worst:.4f}",
          flush=True)
    if exact < EXACT_FLOOR * n_tok or worst > TIE_TOL:
        fail(f"generate: greedy tokens {exact}/{n_tok} the plain forward's "
             f"argmax, worst gap {worst:.3f} (floors {EXACT_FLOOR}, "
             f"{TIE_TOL})")
    return timed["sampled"][2]


# ----------------------------------------------------------------------
# phases 13-14: the shared-prefix cache and the request lifecycle
# ----------------------------------------------------------------------

PREFIX_TOKENS = 512                       # phase 13's shared prefix: 32 pages
PREFIX_SUFFIXES = tuple(range(16, 129, 16))
# phases 13-17's model: Llama-3-8B width cut to 16 layers, which keeps
# the whole script well inside its time limit
PREFIX_LAYERS = 16
# pages: 419,430,400 bytes of bf16 pools at 16 layers
PREFIX_POOL = 400
# phase 14a: 151 usable pages; a completed request pins 15 of them in the
# cache, 8 prompts of 256 tokens take 128 and decode runs short
PRESSURE_POOL, PRESSURE_PROMPT, PRESSURE_NEW = 152, 256, 128
# what phase 14a's schedule gives, the same for both engines on the CPU at
# tiny width (page arithmetic; tests/test_torch_prefix_cache.py): the
# evictions (request, tokens it had emitted) and re-admissions in order,
# then each request's status and output length
PRESSURE_EVENTS = (("evict", 1, 53), ("evict", 0, 68), ("readmit", 0),
                   ("evict", 0, 39), ("evict", 3, 108), ("readmit", 3))
PRESSURE_END = (("evicted", 39), ("evicted", 53)) \
    + (("completed", PRESSURE_NEW),) * 6
# phase 14c: phase 14a's schedule with the host tier on, its cap 24 pages
# of the engine's KV bytes (Llama-3-8B bf16: 2 MiB a page): the first
# victim's 20 pages fit, the second's 21 do not while the first is parked
# (it is evicted instead); the events and ends both engines give on the
# CPU (tests/test_torch_prefix_cache.py)
PAUSE_TIER_PAGES = 24
PAUSE_EVENTS = (("pause", 1, 53), ("pause-evict", 0, 68), ("resume", 1),
                ("readmit", 0))
PAUSE_END = (("completed", PRESSURE_NEW),) * 8
# phase 14b: which request has the 1 ms deadline, which cancels itself
# from its on_token hook at its 8th token, which a second thread cancels
# while a scan is in flight; the statuses and lengths that gives (None:
# timing decides the length; tests/test_torch_serving_lifecycle.py)
LC_DEADLINE, LC_SELF_CANCEL, LC_THREAD_CANCEL, LC_SELF_AT = 2, 5, 7, 8
LIFECYCLE_END = tuple(
    ("deadline_exceeded", None) if i == LC_DEADLINE
    else ("cancelled", LC_SELF_AT) if i == LC_SELF_CANCEL
    else ("cancelled", None) if i == LC_THREAD_CANCEL
    else ("completed", NEW) for i in range(8))


def prefix_traffic(vocab):
    """Phase 13's traffic: one seeded 512-token prefix and 8 prompts, the
    prefix followed by seeded suffixes of 16, 32, ..., 128 tokens."""
    import numpy as np
    rng = np.random.RandomState(13)
    prefix = rng.randint(0, vocab, PREFIX_TOKENS).tolist()
    return prefix, [prefix + rng.randint(0, vocab, n).tolist()
                    for n in PREFIX_SUFFIXES]


def pressure_prompts(vocab):
    """Phase 14a's traffic: a seeded 256-token prompt served first, then
    8 seeded prompts of 256 tokens."""
    import numpy as np
    rng = np.random.RandomState(14)
    other = rng.randint(0, vocab, PRESSURE_PROMPT).tolist()
    return other, [rng.randint(0, vocab, PRESSURE_PROMPT).tolist()
                   for _ in range(8)]


def pool_pages(engine):
    """The engine's pools and scale sidecars, every layer."""
    return engine.k_pools + engine.v_pools + engine.k_scales \
        + engine.v_scales


def hold_allocator(label, engine):
    """Fail unless the engine is idle and its pages all accounted for:
    free pages plus the cache's pinned ones make the usable pages, no
    table is left, no page was released twice."""
    alloc = engine.alloc
    cached = engine.prefix.pages if engine.prefix is not None else 0
    if alloc.free_pages + cached != alloc.num_pages or alloc._tables \
            or alloc.double_free_count or engine._live:
        fail(f"{label}: allocator not consistent at the end: free "
             f"{alloc.free_pages} + cached {cached} of {alloc.num_pages}, "
             f"tables {sorted(alloc._tables)}, double frees "
             f"{alloc.double_free_count}, live {sorted(engine._live)}")


def token_gaps(model, dev, prompts, outs, kv8=False):
    """Each served token's logit gap below the model's own plain forward's
    argmax (with K and V through the int8 quantizer and back for int8
    pages), over every request with output."""
    import torch
    from paddle_tpu_torch.models import llama
    gaps = []
    with plain_serving_paths():
        if kv8:
            llama.causal_attention = kv8_attention
        for p, o in zip(prompts, outs):
            if not o:
                continue
            ids = torch.tensor([list(p) + list(o[:-1])], device=dev)
            with torch.no_grad():
                lg = model(ids)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
    return torch.cat(gaps)


def hold_floor(label, gaps):
    """Hold the served tokens' gaps to phase 4's floors; returns the
    printed summary."""
    n, exact, worst = gaps.numel(), int((gaps == 0).sum()), float(gaps.max())
    if exact < EXACT_FLOOR * n:
        fail(f"{label}: only {exact}/{n} served tokens are the plain "
             f"forward's argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"{label}: served token {worst:.3f} below the plain forward's "
             "argmax")
    return f"plain_forward_exact={exact}/{n} worst_gap={worst:.4f}"


@contextlib.contextmanager
def pool_watch(engine):
    """Count the prompt tokens ``engine`` dispatches and the most pages in
    use (the cache's pins included) once a dispatch or scan has its pages;
    yields ``{"prefill": n, "peak": pages}``."""
    seen = {"prefill": 0, "peak": 0}
    dispatch, load = engine._dispatch_rows, engine._load_scan

    def note():
        seen["peak"] = max(seen["peak"],
                           engine.alloc.num_pages - engine.alloc.free_pages)

    def on_dispatch(rows, cow=()):
        seen["prefill"] += sum(n for _, _, _, n, _, dec in rows if not dec)
        note()
        return dispatch(rows, cow)

    def on_load(*a):
        note()
        return load(*a)
    with instance_attrs(engine, _dispatch_rows=on_dispatch,
                        _load_scan=on_load):
        yield seen


def prefix_run(engine, prompts, label, per_layer, key, keep_pools=False):
    """One run of phase 13's traffic through ``engine``'s entry points:
    request 0 by ``add_request`` (cold with the cache on: its full pages
    are pinned when its prefill ends), then the other 7, then decoding to
    the end. Every launch of the path's kernel counted (``per_layer`` a
    layer a dispatch or tick) and no plain version called; with the cache
    on, the 32 shared pages' K/V (and scales) of every layer held bit for
    bit unchanged from the end of request 0's prefill to the end; the
    allocator consistent at the end. Returns the run's readings."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    layers = engine.model.config.num_hidden_layers
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    cache = engine.prefix
    stats0 = cache.stats() if cache is not None else None
    pools = pool_pages(engine)
    torch.cuda.synchronize()
    with count_calls(serving_plain_versions()) as plain_calls, \
            timed_dispatches(engine) as times, pool_watch(engine) as seen:
        reset_launches()
        t0 = time.perf_counter()
        engine.add_request(reqs[0])
        shared = engine.alloc._tables[reqs[0].seq_id][
            :PREFIX_TOKENS // engine.page_size]
        snap = [t[shared].clone() for t in pools] if cache else None
        for r in reqs[1:]:
            engine.add_request(r)
        while not all(r.done for r in reqs):
            engine.decode_many(NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
    outs = [list(r.output_ids) for r in reqs]
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    want = {k: 0 for k in launches}
    want[key] = per_layer * layers * (mixed + ticks)
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want} ({per_layer} "
             f"x layers x (dispatches + ticks) of {key})")
    if any(len(o) != NEW for o in outs) \
            or any(r.status != "completed" for r in reqs):
        fail(f"{label}: statuses {[r.status for r in reqs]}, lengths "
             f"{[len(o) for o in outs]}")
    res = dict(outs=outs, wall=wall, prefill=seen["prefill"],
               peak=seen["peak"], mixed=mixed, ticks=ticks,
               mixed_ms=1e3 * sum(times["mixed"]) / max(len(times["mixed"]),
                                                        1),
               ttft=[r.ttft for r in reqs], cached=[r._cached_tokens
                                                   for r in reqs],
               launches=launches[key], stats=None)
    if cache is not None:
        s = cache.stats()
        res["stats"] = {k: s[k] - stats0[k] for k in ("lookups", "hits",
                                                      "saved_tokens")}
        same = [torch.equal(t[shared], b) for t, b in zip(pools, snap)]
        if not all(same):
            fail(f"{label}: the shared prefix pages changed in tensors "
                 f"{[i for i, x in enumerate(same) if not x]}")
    hold_allocator(label, engine)
    if keep_pools:
        res["pools"] = [t.clone() for t in pools]
    return res


def check_cow(engine, prefix, label):
    """The engine's copy-on-write on the card: admit a sequence on the
    cached prefix pages, ``ensure_writable`` at a position inside the last
    shared page, so ``_copy_page`` runs. The new page must be bit for bit
    the old in every layer (scales too), every pool and sidecar at its
    address (the tick graphs bake them). Then a replayed tick writes the
    sequence's token into the new page: the old page stays unchanged."""
    import torch
    from paddle_tpu_torch.inference import Request
    page, vocab = engine.page_size, engine.model.config.vocab_size
    pos = PREFIX_TOKENS - page // 2
    # a last token unlike the prefix's at that position: the tick's write
    # differs from what the copy holds
    r = Request(prefix + [(prefix[pos] + 1) % vocab], max_new_tokens=4)
    engine._admit(r)
    if r._cached_tokens != PREFIX_TOKENS:
        fail(f"{label} cow: the sequence matched {r._cached_tokens} cached "
             f"tokens, not {PREFIX_TOKENS}")
    pools = pool_pages(engine)
    ptrs = [t.data_ptr() for t in pools]
    cp = engine.alloc.ensure_writable(r.seq_id, pos)
    if cp is None:
        fail(f"{label} cow: position {pos} is not in a shared page")
    old, new = cp
    before = [t[old].clone() for t in pools]
    engine._copy_page(old, new)
    torch.cuda.synchronize()
    copied = all(torch.equal(t[new], t[old]) for t in pools)
    in_place = [t.data_ptr() for t in pool_pages(engine)] == ptrs
    engine._ensure_tick("greedy")
    engine._load_scan([r], [pos], "greedy", *engine._scan_rows([r]))
    engine._run_tick("greedy")
    torch.cuda.synchronize()
    kept = all(torch.equal(t[old], b) for t, b in zip(pools, before))
    written = not torch.equal(engine.k_pools[0][new], engine.k_pools[0][old])
    engine.cancel(r)
    print(f"{label} cow: page {old} -> {new} copied bitwise over "
          f"{len(pools)} tensors {copied}, in place {in_place}; after a "
          f"replayed tick wrote position {pos} into page {new} "
          f"(changed {written}), page {old} unchanged {kept}", flush=True)
    if not (copied and in_place and kept and written):
        fail(f"{label} cow: copied {copied} in place {in_place} old kept "
             f"{kept} new written {written}")
    hold_allocator(f"{label} cow", engine)


def serve_prefix(dev, model, kv_dtype=None):
    """Phase 13 (bf16 pools) and 13b (``kv_dtype="int8"``): Llama-3-8B at
    full width and depth behind ``LlamaServingEngine(max_batch=8,
    page_size=16, num_pages=400)``, graphed, serving phase 13's traffic
    (:func:`prefix_traffic`, 32 new tokens each, greedy) twice on one
    model: with the prefix cache (the engine's default), then without.
    Held: over the phase's 8 requests 8 lookups, 7 hits and 7 x 512 saved
    prefill tokens; 1088 prompt tokens dispatched with the cache against
    4672 without; the shared pages unchanged (:func:`prefix_run`); every
    token at phase 4's floors against the plain forward, both runs; then
    the copy-on-write check on the cached engine. Returns the launches of
    #12 (#13 on int8 pools)."""
    import torch
    label = "prefix int8-kv" if kv_dtype else "prefix"
    key = "fused_rope_q8" if kv_dtype else "fused_rope"
    prefix, prompts = prefix_traffic(model.config.vocab_size)
    runs = {}
    for on in (True, False):
        engine = serving_engine(model, kv_dtype, prefix_cache=on,
                                num_pages=PREFIX_POOL)
        warm_up(engine, prompts)
        run_label = f"{label} cache={'on' if on else 'off'}"
        runs[on] = prefix_run(engine, prompts, run_label, 2, key)
        res = runs[on]
        res["floor"] = hold_floor(run_label, token_gaps(
            model, dev, prompts, res["outs"], kv8=bool(kv_dtype)))
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in pool_pages(engine))
        if on:
            check_cow(engine, prefix, label)
        del engine
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    want = {"lookups": 8, "hits": 7,
            "saved_tokens": 7 * PREFIX_TOKENS}
    full = sum(map(len, prompts))
    cold = len(prompts[0]) + sum(n for n in PREFIX_SUFFIXES[1:])
    n_tok = len(prompts) * NEW
    eq = sum(a == b for o, ob in zip(on["outs"], off["outs"])
             for a, b in zip(o, ob))
    print(f"{label}: kv_pool_bytes={kv_bytes} requests={len(prompts)} "
          f"prompt_tokens={full} shared_prefix={PREFIX_TOKENS} new_tokens="
          f"{n_tok}; cache stats over the phase {on['stats']} (want "
          f"{want}); prompt tokens dispatched {on['prefill']} with the "
          f"cache, {off['prefill']} without (want {cold}, {full}); "
          f"tokens equal between the runs {eq}/{n_tok}", flush=True)
    for name, res in (("cache on", on), ("cache off", off)):
        print(f"{label} {name}: dispatches={res['mixed']} ticks="
              f"{res['ticks']} mixed_dispatch_ms={res['mixed_ms']:.2f} "
              f"wall_s={res['wall']:.3f} tokens_per_s="
              f"{n_tok / res['wall']:.1f} peak_pages={res['peak']} "
              f"ttft_ms={[round(1e3 * t, 1) for t in res['ttft']]} "
              f"cached_tokens={res['cached']} launches={res['launches']} "
              f"{res['floor']}", flush=True)
    if on["stats"] != want or on["prefill"] != cold \
            or off["prefill"] != full:
        fail(f"{label}: cache stats {on['stats']} (want {want}), prompt "
             f"tokens dispatched {on['prefill']} / {off['prefill']} (want "
             f"{cold} / {full})")
    return on["launches"] + off["launches"]


def serve_prefix_paths(dev):
    """Phase 13c: phase 13's traffic with the prefix cache at Llama-3-8B
    width cut to 4 layers through the engine's three attention paths
    (rope-fused #12 / #13, ``fused_rope=False`` #11a / #11b,
    ``fused_kv=False`` #10 / #9), both KV dtypes, graphed: every path's
    checks of :func:`prefix_run` and the same cache stats, and the warm
    requests' tokens, the pools and the sidecars bit for bit equal across
    the paths. Returns the launches of each path by its launch-count
    key."""
    import torch
    cfg, model = llama_model(dev, LADDER_LAYERS)
    prefix, prompts = prefix_traffic(cfg.vocab_size)
    want = {"lookups": 8, "hits": 7, "saved_tokens": 7 * PREFIX_TOKENS}
    counts = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for path, (kw, per_layer, key) in LADDER.items():
            key += "_q8" if kv_dtype else ""
            label = f"prefix paths {kv_dtype or 'bf16'} {path}"
            engine = serving_engine(model, kv_dtype, prefix_cache=True,
                                    num_pages=PREFIX_POOL, **kw)
            warm_up(engine, prompts)
            res = prefix_run(engine, prompts, label, per_layer, key,
                             keep_pools=True)
            if res["stats"] != want:
                fail(f"{label}: cache stats {res['stats']}, want {want}")
            counts[key] = res["launches"]
            runs[path] = res
            del engine
            torch.cuda.empty_cache()
        base = runs["rope-fused"]
        for path in ("fused-kv", "two-op"):
            res = runs[path]
            label = f"prefix paths {kv_dtype or 'bf16'} {path}"
            if res["outs"] != base["outs"]:
                fail(f"{label}: warm tokens differ from the rope-fused "
                     "path's")
            if not all(torch.equal(a, b) for a, b in zip(res["pools"],
                                                        base["pools"])):
                fail(f"{label}: pools or sidecars differ from the "
                     "rope-fused path's bit for bit")
        print(f"prefix paths {kv_dtype or 'bf16'}: the three paths' warm "
              f"tokens identical, pools and sidecars "
              f"({len(base['pools'])} tensors) bitwise equal; cache stats "
              f"{base['stats']}; prompt tokens dispatched "
              f"{base['prefill']}; launches "
              f"{ {p: r['launches'] for p, r in runs.items()} }", flush=True)
    return counts


def pressure_schedule(engine, req_cls, other, prompts):
    """Phase 14a's schedule on ``engine`` (either package's engine: the
    CPU tests run it on both), and with the host tier on phase 14c's:
    ``other`` served to completion, its full pages pinned by the cache;
    then 8 requests of ``prompts``, PRESSURE_NEW new tokens each,
    priorities 0, 0, 1, 1, 2, 2, 3, 3, retry budget 1 but 0 for the
    second, each by ``add_request``; then decoding to the end. Returns
    (the requests, the ladder's events in order, the cache's pages after
    ``other``, the cache's evictions when the first live request left).
    The events: ``("evict", i, tokens emitted)``, ``("pause", i,
    tokens)``, ``("pause-evict", i, tokens)`` (a pause the tier could not
    hold, evicted instead), ``("resume", i)`` and ``("readmit", i)``."""
    events, reqs, first = [], [], {}
    evict, admit = engine._evict, engine._admit_locked
    pause, resume = engine._pause, engine._try_resume
    pausing = []

    def index(r):
        return next((i for i, x in enumerate(reqs) if x is r), -1)

    def on_evict(v):
        first.setdefault("cache_evictions", engine.prefix.evictions)
        if not pausing:
            events.append(("evict", index(v), len(v.output_ids)))
        return evict(v)

    def on_pause(v):
        first.setdefault("cache_evictions", engine.prefix.evictions)
        n = len(v.output_ids)
        pausing.append(v)
        try:
            out = pause(v)
        finally:
            pausing.pop()
        events.append(("pause" if v.status == "paused" else "pause-evict",
                       index(v), n))
        return out

    def on_resume(req):
        out = resume(req)
        if req.status == "live":
            events.append(("resume", index(req)))
        return out

    def on_admit(req, quiet_retry=False):
        out = admit(req, quiet_retry=quiet_retry)
        if quiet_retry and req.status == "live":
            events.append(("readmit", index(req)))
        return out
    with instance_attrs(engine, _evict=on_evict, _admit_locked=on_admit,
                        _pause=on_pause, _try_resume=on_resume):
        w = req_cls(other, max_new_tokens=4)
        engine.add_request(w)
        while not w.done:
            engine.step()
        cached = engine.prefix.pages
        reqs.extend(req_cls(p, max_new_tokens=PRESSURE_NEW, priority=i // 2,
                            retry_budget=0 if i == 1 else 1)
                    for i, p in enumerate(prompts))
        for r in reqs:
            engine.add_request(r)
        while not all(r.done for r in reqs):
            engine.decode_many(engine.decode_ticks)
    return reqs, tuple(events), cached, first.get("cache_evictions")


def lifecycle_schedule(engine, req_cls, prompts, in_scan):
    """Phase 14b's schedule on ``engine`` (either package's), a pool that
    holds everything: 8 requests of ``prompts`` (NEW new tokens) admitted,
    request LC_DEADLINE last with a 1 ms deadline, LC_SELF_CANCEL
    cancelling itself from its ``on_token`` hook at its LC_SELF_AT-th
    token; then a 9th admission, priority 0, into the full engine (it
    backs off ``admit_retries`` times and is shed); ``in_scan(engine,
    fn)`` arranges for ``fn`` to run once inside the next decode scan, and
    ``fn`` cancels LC_THREAD_CANCEL from a second thread there; once that
    request is done a fresh request of its prompt is admitted on what it
    released; then decoding to the end. Returns (the 8 requests, the
    shed's error or None, the fresh request, what ``fn`` saw)."""
    import threading
    reqs = []
    for i, p in enumerate(prompts):
        kw = {}
        if i == LC_DEADLINE:
            kw["deadline"] = 1e-3
        if i == LC_SELF_CANCEL:
            kw["on_token"] = lambda r, t: len(r.output_ids) == LC_SELF_AT \
                and engine.cancel(r)
        reqs.append(req_cls(p, max_new_tokens=NEW, **kw))
    for i in [i for i in range(len(reqs)) if i != LC_DEADLINE] \
            + [LC_DEADLINE]:
        engine._admit(reqs[i])
    shed = None
    try:
        engine._admit(req_cls(prompts[0], max_new_tokens=NEW, priority=0))
    except MemoryError as e:          # either package's AdmissionError
        shed = e
    victim, seen = reqs[LC_THREAD_CANCEL], {}

    def cancel_from_thread():
        seen["table"] = list(engine.alloc._tables[victim.seq_id])
        t = threading.Thread(target=engine.cancel, args=(victim,))
        t.start()
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("the second thread's cancel did not return")
        seen["deferred"] = list(engine._deferred_release)
        seen["tables"] = victim.seq_id in engine.alloc._tables
    in_scan(engine, cancel_from_thread)
    fresh = None
    while not all(r.done for r in reqs) \
            or (fresh is not None and not fresh.done):
        engine.decode_many(engine.decode_ticks)
        if victim.done and fresh is None:
            fresh = req_cls(prompts[LC_THREAD_CANCEL], max_new_tokens=NEW)
            engine.add_request(fresh)
            seen["fresh_table"] = list(engine.alloc._tables.get(
                fresh.seq_id, ()))
    return reqs, shed, fresh, seen


def in_first_tick(engine, fn):
    """Run ``fn`` once, right after the next scan's first tick is
    launched (the scan is in flight; its pages are held)."""
    run = engine._run_tick

    def once(mode):
        engine._run_tick = run
        out = run(mode)
        fn()
        return out
    engine._run_tick = once


@contextlib.contextmanager
def profiled_tick(engine):
    """Count the launches of ``engine``'s first tick replay in the context
    as phase 4b does: the profiler over that one replay and the wrappers
    (its capture's counts); yields ``{"prof": {family: n}, "py": {family:
    n}, "s": host seconds in the profiler's window}`` once it ran (a
    timed run's wall holds those seconds, ``PROFILE_PAD_S`` twice
    included)."""
    seen = {}
    run = engine._run_tick

    def first(mode):
        if seen:
            return run(mode)
        py0 = python_launches()
        t0 = time.perf_counter()
        out, seen["prof"], _ = profiled_launches(lambda: run(mode))
        seen["s"] = time.perf_counter() - t0
        seen["py"] = {k: v - py0[k] for k, v in python_launches().items()
                      if v != py0[k]}
        return out
    with instance_attrs(engine, _run_tick=first):
        yield seen


def hold_replay(label, replay, layers):
    """Hold one replay's launches (:func:`profiled_tick`): the profiler's
    the wrappers', a write and an attention a layer."""
    if not replay:
        fail(f"{label}: no tick was replayed")
    hold_profiled(f"{label} one replay", replay["prof"], replay["py"])
    if replay["prof"].get("write") != layers \
            or replay["prof"].get("attention") != layers:
        fail(f"{label}: one replay launched {replay['prof']}, want a write "
             f"and an attention a layer ({layers})")


def serve_pressure(dev, model):
    """Phase 14a: phase 13's model, graphed, on a pool of 152 pages (151
    usable), :func:`pressure_schedule` with phase 14a's prompts. Held:
    the cache pins 15 pages after the first request, gives back at least
    those before any live request is evicted, the evictions and
    re-admissions and every request's status and output length are
    PRESSURE_EVENTS / PRESSURE_END (the CPU schedule's), the evicted
    requests carry their typed AdmissionError, every completed request's
    tokens hold phase 4's floors, the allocator is consistent at the end,
    no plain version runs, every launch is counted (2 a layer a dispatch
    or tick) and one tick replay counted by the profiler and the
    wrappers, as phase 4b counts it. Returns the launches of #12 and the
    run's tokens, wall and prompt tokens dispatched (phase 14c prints
    them beside its own)."""
    import torch
    from paddle_tpu_torch.inference import AdmissionError, Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    label = "pressure"
    layers = model.config.num_hidden_layers
    other, prompts = pressure_prompts(model.config.vocab_size)
    engine = serving_engine(model, prefix_cache=True,
                            num_pages=PRESSURE_POOL)
    warm_up(engine, prompts)
    with count_calls(serving_plain_versions()) as plain_calls, \
            timed_dispatches(engine) as times, \
            profiled_tick(engine) as replay, pool_watch(engine) as seen:
        reset_launches()
        t0 = time.perf_counter()
        reqs, events, cached, cache_ev = pressure_schedule(
            engine, Request, other, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
    end = tuple((r.status, len(r.output_ids)) for r in reqs)
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    want = {k: 0 for k in launches}
    want["fused_rope"] = 2 * layers * (mixed + ticks)
    done = [(p, r.output_ids) for p, r in zip(prompts, reqs)
            if r.status == "completed"]
    floor = hold_floor(label, token_gaps(model, dev, *zip(*done)))
    n_tok = sum(len(r.output_ids) for r in reqs)
    first = len(other) + sum(map(len, prompts))
    print(f"{label}: pool {engine.alloc.num_pages} usable pages, "
          f"{cached} cached after the first request, cache evictions "
          f"before the first live eviction {cache_ev}; events {events}; "
          f"end {end}; dispatches={mixed} ticks={ticks} wall_s={wall:.3f} "
          f"tokens_per_s={n_tok / wall:.1f} prompt tokens re-prefilled "
          f"{seen['prefill'] - first} launches={launches['fused_rope']}"
          f"; one replay (profiler window {replay.get('s', 0):.3f} s of the "
          f"wall): profiler {replay.get('prof')}, wrappers "
          f"{replay.get('py')}; {floor}", flush=True)
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want}")
    hold_replay(label, replay, layers)
    if cached != PRESSURE_PROMPT // engine.page_size - 1 \
            or cache_ev is None or cache_ev < cached:
        fail(f"{label}: {cached} pages cached after the first request, "
             f"{cache_ev} given back before the first live eviction")
    if events != PRESSURE_EVENTS or end != PRESSURE_END:
        fail(f"{label}: events {events} / end {end}, the CPU schedule's "
             f"{PRESSURE_EVENTS} / {PRESSURE_END}")
    for r in reqs:
        if (r.status == "evicted") != isinstance(r.error, AdmissionError):
            fail(f"{label}: status {r.status} with error {r.error!r}")
    hold_allocator(label, engine)
    return launches["fused_rope"], dict(tokens=n_tok, wall=wall,
                                        prefill=seen["prefill"])


def serve_lifecycle(dev, model):
    """Phase 14b: phase 13's model, graphed, ``admit_retries=2``, on a
    pool that holds everything (400 pages), :func:`lifecycle_schedule`
    with phase 4's prompts; the second-thread cancel lands after the
    first tick of the first scan is launched. Held: the 9th admission
    shed as "engine full" after 2 retries with a ``retry_after``; every
    request's status (and, where timing does not decide it, its output
    length) LIFECYCLE_END's; the thread-cancelled request's release
    deferred past the scan (its table still held inside it); the fresh
    request admitted on its released pages, completed, its tokens and the
    completed requests' at phase 4's floors; the allocator consistent;
    no plain version run; launches counted as phase 14a. Returns the
    launches of #12."""
    import torch
    from paddle_tpu_torch.inference import AdmissionError, Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    label = "lifecycle"
    layers = model.config.num_hidden_layers
    prompts = serving_prompts(model.config.vocab_size)
    engine = serving_engine(model, prefix_cache=True, num_pages=PREFIX_POOL,
                            admit_retries=2)
    warm_up(engine, prompts)
    with count_calls(serving_plain_versions()) as plain_calls, \
            timed_dispatches(engine) as times, \
            profiled_tick(engine) as replay:
        reset_launches()
        t0 = time.perf_counter()
        reqs, shed, fresh, seen = lifecycle_schedule(
            engine, Request, prompts, in_first_tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
    end = tuple((r.status, len(r.output_ids)) for r in reqs)
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    want = {k: 0 for k in launches}
    want["fused_rope"] = 2 * layers * (mixed + ticks)
    reused = sorted(set(seen.get("table", ())) & set(seen.get(
        "fresh_table", ())))
    done = [(p, r.output_ids) for p, r in zip(prompts, reqs)
            if r.status == "completed"]
    done.append((prompts[LC_THREAD_CANCEL], fresh.output_ids))
    floor = hold_floor(label, token_gaps(model, dev, *zip(*done)))
    print(f"{label}: shed {shed!r}; end {end}; fresh request "
          f"{fresh.status} {len(fresh.output_ids)} tokens on "
          f"{len(reused)} pages of the cancelled one's {reused}; release "
          f"deferred inside the scan {seen.get('deferred')} (table still "
          f"held {seen.get('tables')}); dispatches={mixed} ticks={ticks} "
          f"wall_s={wall:.3f} launches={launches['fused_rope']}; one replay "
          f"(profiler window {replay.get('s', 0):.3f} s of the wall): "
          f"profiler {replay.get('prof')}, wrappers {replay.get('py')}; "
          f"{floor}", flush=True)
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want}")
    hold_replay(label, replay, layers)
    if not isinstance(shed, AdmissionError) or shed.reason != "engine full" \
            or shed.retries != 2 or not shed.retry_after:
        fail(f"{label}: the 9th admission gave {shed!r}")
    if any(s != w or (n is not None and n != m)
           for (s, m), (w, n) in zip(end, LIFECYCLE_END)):
        fail(f"{label}: end {end}, the CPU schedule's {LIFECYCLE_END}")
    if not seen.get("tables") or reqs[LC_THREAD_CANCEL].seq_id \
            not in seen.get("deferred", ()) or not reused \
            or fresh.status != "completed" or len(fresh.output_ids) != NEW:
        fail(f"{label}: the cancel in flight: {seen}, fresh "
             f"{fresh.status} {fresh.output_ids}")
    hold_allocator(label, engine)
    return launches["fused_rope"]


# ----------------------------------------------------------------------
# phases 14c-14d: the host KV tier
# ----------------------------------------------------------------------

# phase 14c's lone request: paused at this many emitted tokens
PAUSE_AT = 4
# phase 14d's copy chaos, the reference test's plan (tests/test_kv_tier.py)
# on its tight pool (2 rows, 7 usable pages of 8 slots, 3 requests of 3
# tokens with 40 new each, retry budget 6); the tier's failure counts both
# engines give on the CPU, both KV dtypes (tests/test_torch_kv_tier.py)
CHAOS_PLAN = (
    {"point": "tier.d2h", "action": "sleep", "seconds": 0.01, "count": 2},
    {"point": "tier.d2h", "action": "raise", "exc": "OSError", "count": 1,
     "path": "seq"},
    {"point": "tier.h2d", "action": "raise", "exc": "OSError", "count": 1,
     "path": "seq"},
    {"point": "tier.h2d", "action": "bitflip", "count": 1, "path": "seq"},
)
CHAOS_GEOM = dict(max_batch=2, page_size=8, num_pages=8)
CHAOS_NEW, CHAOS_RETRIES = 40, 6
CHAOS_STATS = {"exports": 3, "restores": 1, "export_failures": 1,
               "restore_failures": 1, "crc_failures": 1}


def chaos_prompts():
    """Phase 14d's chaos traffic: 3 prompts of 3 tokens."""
    import numpy as np
    return [((np.arange(3) + 7 * i) % 50 + 1).tolist() for i in range(3)]


def chaos_schedule(engine, req_cls, retry_budget=CHAOS_RETRIES):
    """Phase 14d's chaos drive on ``engine`` (either package's; the CPU
    tests run it on both) while the caller has CHAOS_PLAN active: the
    requests of :func:`chaos_prompts` admitted with retries (an
    admission shed is backpressure), single steps until every request is
    terminal. Returns the requests."""
    reqs = [req_cls(p, max_new_tokens=CHAOS_NEW, retry_budget=retry_budget)
            for p in chaos_prompts()]
    pending, steps = list(reqs), 0
    while any(not r.done for r in reqs) and steps < 1500:
        for r in list(pending):
            try:
                engine.add_request(r)
                pending.remove(r)
            except MemoryError:           # either package's AdmissionError
                pass
        engine.step()
        steps += 1
    return reqs


@contextlib.contextmanager
def fault_plan(rules):
    """The port's fault plan ``rules`` active in the context."""
    from paddle_tpu_torch.testing import faults
    os.environ[faults.PLAN_ENV] = json.dumps(list(rules))
    faults.reset()
    try:
        yield
    finally:
        os.environ.pop(faults.PLAN_ENV, None)
        faults.reset()


@contextlib.contextmanager
def tier_watch(engine):
    """Time ``engine``'s host tier on the host clock, synchronised: each
    export of a paused sequence split into its gather and device-to-host
    copy (``_gather_host``) and its CRC (``_page_crcs``), each restore
    with whether it found its copy staged, and the tier's peak bytes.
    Yields ``{"export": [(copy s, crc s, pages, stored)], "restore":
    [(s, staged, pages)], "peak": bytes}``."""
    import torch
    from paddle_tpu_torch.inference import kv_tier as KT
    tier = engine.tier
    seen = {"export": [], "restore": [], "peak": 0}
    gather, crcs = KT._gather_host, KT._page_crcs
    export, restore, put = tier.export_seq, tier.restore_seq, tier.put_prefix
    part = {}

    def timed_gather(pools, idx):
        t0 = time.perf_counter()
        out = gather(pools, idx)
        part["copy"] = time.perf_counter() - t0
        return out

    def timed_crcs(arrays, n):
        t0 = time.perf_counter()
        out = crcs(arrays, n)
        part["crc"] = time.perf_counter() - t0
        return out

    def on_export(k_pools, v_pools, k_scales, v_scales, table, *a, **kw):
        part.clear()
        stored = False
        try:
            key = export(k_pools, v_pools, k_scales, v_scales, table, *a,
                         **kw)
            stored = True
        finally:
            seen["export"].append((part.get("copy"), part.get("crc"),
                                   len(table), stored))
            seen["peak"] = max(seen["peak"], tier.bytes)
        return key

    def on_put(*a, **kw):
        out = put(*a, **kw)
        seen["peak"] = max(seen["peak"], tier.bytes)
        return out

    def on_restore(key, *a, **kw):
        staged = tier._staged.get(key) is not None
        pages = tier._seqs[key].n_pages if key in tier._seqs else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return restore(key, *a, **kw)
        finally:
            torch.cuda.synchronize()
            seen["restore"].append((time.perf_counter() - t0, staged, pages))
    KT._gather_host, KT._page_crcs = timed_gather, timed_crcs
    try:
        with instance_attrs(tier, export_seq=on_export, put_prefix=on_put,
                            restore_seq=on_restore):
            yield seen
    finally:
        KT._gather_host, KT._page_crcs = gather, crcs


def tier_line(seen):
    """What phases 14c and 14d print of :func:`tier_watch`'s record."""
    ex = [f"{1e3 * c:.3f}+{1e3 * k:.3f}ms/{n}p{'' if ok else '(full)'}"
          for c, k, n, ok in seen["export"] if c is not None]
    rs = [f"{1e3 * s:.3f}ms/{n}p{' staged' if st else ''}"
          for s, st, n in seen["restore"]]
    return (f"exports (copy+crc ms / pages) {ex}; restores {rs}; peak host "
            f"bytes {seen['peak']}")


def wait_staged(tier, key, timeout=30.0):
    """Wait until the tier's staging thread has ``key`` on the device."""
    t0 = time.perf_counter()
    while tier._staged.get(key) is None:
        if time.perf_counter() - t0 > timeout:
            fail(f"tier key {key} was not staged within {timeout} s")
        time.sleep(0.005)


def lone_runs(engine, prompt, new, label):
    """Phase 14c's and 14d's lone request on ``engine``: uninterrupted, then
    paused from the host at PAUSE_AT tokens and resumed unstaged, then
    paused there, its restore staged (a tick graph captured meanwhile on
    the card) and waited for, and resumed; each
    driven by the same calls (``add_request``, single steps to PAUSE_AT
    tokens, one more step, then ``decode_many``), so every dispatch has
    the same shape. Held: the three runs' tokens bitwise equal; each
    restore writes the pages and sidecars bitwise as they were before the
    export, and no pool or sidecar changes address. Returns the
    requests."""
    import torch
    from paddle_tpu_torch.inference import Request
    pools = pool_pages(engine)
    ptrs = [t.data_ptr() for t in pools]
    reqs = []
    for mode in ("uninterrupted", "unstaged", "staged"):
        r = Request(prompt, max_new_tokens=new)
        engine.add_request(r)
        while len(r.output_ids) < PAUSE_AT:
            engine.step()
        snap = {}
        if mode != "uninterrupted":
            table, n = engine.alloc.export_table(r.seq_id)
            table = table[:-(-n // engine.page_size)]
            snap["before"] = [t[table].clone() for t in pools]
            with engine._lock:
                engine._pause(r)
            if r.status != "paused":
                fail(f"{label} lone: the pause left status {r.status}")
            if mode == "staged":
                engine.tier.stage(r._tier_key)
                if engine._graphs.cuda:
                    # a tick graph captured while the copy stages: the two
                    # never overlap (the capture lock); its warm-up tick
                    # is no dispatch of the path, so it is not counted
                    from paddle_tpu_torch.ops import _build
                    counts = [dict(c) for c in _build.COUNTERS]
                    engine._load_scan([], [], "greedy", [], [])
                    engine._graphs.capture(
                        ("staging", len(reqs)),
                        lambda: engine._tick("greedy"))
                    for c, before in zip(_build.COUNTERS, counts):
                        c.update(before)
                wait_staged(engine.tier, r._tier_key)
            resume = engine._try_resume

            def snap_after(req, resume=resume, snap=snap):
                out = resume(req)
                if req.status == "live":
                    t = engine.alloc._tables[req.seq_id][:len(table)]
                    snap["after"] = [p[t].clone() for p in pools]
                return out
            with instance_attrs(engine, _try_resume=snap_after):
                engine.step()
            if "after" not in snap:
                fail(f"{label} lone {mode}: not resumed at the next step")
            same = [torch.equal(a, b) for a, b in zip(snap["before"],
                                                     snap["after"])]
            if not all(same):
                fail(f"{label} lone {mode}: restored pages differ from the "
                     f"exported ones in tensors "
                     f"{[i for i, x in enumerate(same) if not x]}")
        else:
            engine.step()
        while not r.done:
            engine.decode_many(new)
        reqs.append(r)
    if [t.data_ptr() for t in pool_pages(engine)] != ptrs:
        fail(f"{label} lone: a pool or sidecar changed address")
    outs = [r.output_ids for r in reqs]
    if any(o != outs[0] for o in outs[1:]) or len(outs[0]) != new:
        fail(f"{label} lone: paused runs' tokens differ from the "
             f"uninterrupted run's: {outs}")
    return reqs


def in_flight_pause(engine, prompt, new, label):
    """A second thread pauses a request right after the first tick of a
    graphed decode scan that holds it is launched; then one step resumes
    it and ``decode_many`` finishes it (the uninterrupted run of
    :func:`lone_runs` takes the same calls past PAUSE_AT tokens). Held: the
    pause exported the committed tokens, not the scan's reservation; its
    release waited for the scan; the scan's tokens for the row were
    dropped. Returns (the request, what the pause saw)."""
    import threading
    from paddle_tpu_torch.inference import Request
    r = Request(prompt, max_new_tokens=new)
    engine.add_request(r)
    while len(r.output_ids) < PAUSE_AT:
        engine.step()
    seen = {}

    def pause():
        sid = r.seq_id
        seen["lens"] = engine.alloc._lens[sid]
        seen["out"] = len(r.output_ids)
        t = threading.Thread(target=lambda: engine._pause(r))
        t.start()
        t.join(timeout=120)
        if t.is_alive():
            raise RuntimeError("the second thread's pause did not return")
        seen["deferred"] = sid in engine._deferred_release
        seen["tokens"] = engine.tier.seq_tokens(r._tier_key)
    in_first_tick(engine, pause)
    with engine._lock:
        n = engine._scan_fits([r], engine.decode_ticks)
    engine._decode_scan(n)
    committed = len(prompt) + seen.get("out", -1) - 1
    if r.status != "paused" or not seen.get("deferred") \
            or seen.get("tokens") != committed \
            or not committed < seen.get("lens", 0) \
            or len(r.output_ids) != seen.get("out"):
        fail(f"{label} in flight: status {r.status}, seen {seen}, "
             f"committed {committed}, output {len(r.output_ids)}")
    engine.step()
    while not r.done:
        engine.decode_many(new)
    return r, seen


def serve_pause(dev, model, pressure):
    """Phase 14c: phase 14a's model and traffic, graphed, with the host
    KV tier on, its cap PAUSE_TIER_PAGES pages of Llama-3-8B's bf16 KV
    (:func:`pressure_schedule`). Held: the pauses, the pause the tier
    could not hold, the resume and the re-admission in order and every
    request's status and output length are PAUSE_EVENTS / PAUSE_END (the
    CPU schedule's); the tokens at phase 4's floors; no paused copy left
    in the tier and the allocator consistent; no plain version run;
    every launch counted. Printed: each export's copy and CRC ms, each
    restore's ms (staged or not), the tier's peak bytes, tokens/s and the
    prompt tokens re-prefilled, beside phase 14a's (``pressure``). Then
    on a fresh engine of the same geometry without the cache,
    :func:`lone_runs` and :func:`in_flight_pause`; then phase 13's prefix
    demoted into the tier and promoted back by a same-prefix request:
    the promotions counted, the tokens bitwise the warm run's. Returns
    the launches of #12."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    label = "pause"
    layers = model.config.num_hidden_layers
    other, prompts = pressure_prompts(model.config.vocab_size)
    engine = serving_engine(model, prefix_cache=True,
                            num_pages=PRESSURE_POOL, kv_tier=True)
    engine.tier.max_bytes = PAUSE_TIER_PAGES * engine.page_size \
        * engine.kv_bytes_per_token
    warm_up(engine, prompts)
    with count_calls(serving_plain_versions()) as plain_calls, \
            timed_dispatches(engine) as times, pool_watch(engine) as seen, \
            tier_watch(engine) as tw:
        reset_launches()
        t0 = time.perf_counter()
        reqs, events, cached, cache_ev = pressure_schedule(
            engine, Request, other, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
    end = tuple((r.status, len(r.output_ids)) for r in reqs)
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    want = {k: 0 for k in launches}
    want["fused_rope"] = 2 * layers * (mixed + ticks)
    done = [(p, r.output_ids) for p, r in zip(prompts, reqs)
            if r.status == "completed"]
    floor = hold_floor(label, token_gaps(model, dev, *zip(*done)))
    n_tok = sum(len(r.output_ids) for r in reqs)
    first = len(other) + sum(map(len, prompts))
    st = engine.tier.stats()
    print(f"{label}: tier cap {PAUSE_TIER_PAGES} pages "
          f"({engine.tier.max_bytes} bytes); events {events}; end {end}; "
          f"tier stats {st}; {tier_line(tw)}; dispatches={mixed} "
          f"ticks={ticks} wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f}"
          f" prompt tokens re-prefilled {seen['prefill'] - first} "
          f"(phase 14a, evict only: tokens_per_s="
          f"{pressure['tokens'] / pressure['wall']:.1f}, re-prefilled "
          f"{pressure['prefill'] - first}); launches="
          f"{launches['fused_rope']}; {floor}", flush=True)
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want}")
    if events != PAUSE_EVENTS or end != PAUSE_END:
        fail(f"{label}: events {events} / end {end}, the CPU schedule's "
             f"{PAUSE_EVENTS} / {PAUSE_END}")
    if st["seqs"] or st["bytes"] != st["prefix_pages"] * engine.page_size \
            * engine.kv_bytes_per_token:
        fail(f"{label}: the tier holds more than demoted prefix pages: {st}")
    hold_allocator(label, engine)
    del engine
    torch.cuda.empty_cache()
    count = launches["fused_rope"]
    # the lone request and the pause in flight, on the same geometry
    engine = serving_engine(model, num_pages=PRESSURE_POOL, kv_tier=True)
    warm_up(engine, prompts)
    with tier_watch(engine) as tw, count_calls(
            serving_plain_versions()) as plain_calls:
        reset_launches()
        lone = lone_runs(engine, prompts[0], NEW, label)
        r, saw = in_flight_pause(engine, prompts[0], NEW, label)
        count += rpa.launches["fused_rope"]
    if plain_calls:
        fail(f"{label} lone: plain versions ran on the card")
    if r.output_ids != lone[0].output_ids:
        fail(f"{label} in flight: tokens differ from the uninterrupted "
             f"run's: {r.output_ids} / {lone[0].output_ids}")
    hold_floor(f"{label} lone", token_gaps(model, dev, [prompts[0]],
                                            [lone[0].output_ids]))
    hold_allocator(f"{label} lone", engine)
    if engine.tier.stats()["seqs"] or engine.tier.bytes:
        fail(f"{label} lone: the tier kept {engine.tier.stats()}")
    print(f"{label} lone: paused at {PAUSE_AT} tokens and resumed unstaged "
          f"and staged, and paused from a second thread inside a scan "
          f"(allocator {saw['lens']} tokens, exported the {saw['tokens']} "
          f"committed): tokens bitwise the uninterrupted run's, restored "
          f"pages bitwise, pools in place; {tier_line(tw)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    count += serve_promotion(dev, model, label)
    return count


def serve_promotion(dev, model, label):
    """Phase 14c's prefix promotion: phase 13's geometry with the tier on;
    one of phase 13's prompts served cold, then warm (matching its own
    pinned pages), then every cached page evicted (demoted into the tier)
    and the prompt served a third time: its chain promoted back page by
    page, the same cached tokens as the warm run, the tokens bitwise the
    warm run's, the pools in place. Returns the launches of #12."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.inference.prefix_cache import cacheable_pages
    _, prompts = prefix_traffic(model.config.vocab_size)
    prompt = prompts[1]
    engine = serving_engine(model, prefix_cache=True, num_pages=PREFIX_POOL,
                            kv_tier=True)
    warm_up(engine, prompts)
    ptrs = [t.data_ptr() for t in pool_pages(engine)]
    reset_launches()
    runs = []
    for i in range(3):
        if i == 2:
            engine.prefix.evict_pages(engine.prefix.pages)
        r = Request(prompt, max_new_tokens=NEW)
        engine.add_request(r)
        while not r.done:
            engine.decode_many(NEW)
        runs.append(r)
    st = engine.tier.stats()
    want = cacheable_pages(len(prompt), engine.page_size)
    print(f"{label} promotion: cached tokens {[r._cached_tokens for r in runs]}"
          f"; tier {st}; tokens of the promoted run equal to the warm run's "
          f"{runs[2].output_ids == runs[1].output_ids}", flush=True)
    if runs[2].output_ids != runs[1].output_ids \
            or runs[2]._cached_tokens != runs[1]._cached_tokens \
            or st["prefix_promotions"] != want \
            or [t.data_ptr() for t in pool_pages(engine)] != ptrs:
        fail(f"{label} promotion: cached {[r._cached_tokens for r in runs]}, "
             f"promotions {st['prefix_promotions']} (want {want}), tokens "
             f"{runs[2].output_ids} / {runs[1].output_ids}")
    hold_allocator(f"{label} promotion", engine)
    count = rpa.launches["fused_rope"]
    del engine
    torch.cuda.empty_cache()
    return count


def serve_pause_paths(dev):
    """Phase 14d: phase 13c's 4-layer cut (LADDER_LAYERS) through the
    three attention paths, both KV dtypes, graphed, with the host tier
    on: :func:`lone_runs` and :func:`in_flight_pause` on phase 4's
    longest prompt (restored pages and int8 sidecars bitwise the
    exported ones, the pools in place, tokens bitwise the uninterrupted
    run's), the tokens and the pools and sidecars after the lone runs
    bitwise equal across the paths; then CHAOS_PLAN on the reference
    test's tight pool (:func:`chaos_schedule`): every request completed
    or failed typed, the tier's counts CHAOS_STATS (the CPU's), nothing
    leaked. Returns the launches of each path by its
    launch-count key."""
    import torch
    from paddle_tpu_torch.inference import LlamaServingEngine, Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    cfg, model = llama_model(dev, LADDER_LAYERS)
    prompt = serving_prompts(cfg.vocab_size)[-1]
    counts = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for path, (kw, per_layer, key) in LADDER.items():
            key += "_q8" if kv_dtype else ""
            label = f"pause paths {kv_dtype or 'bf16'} {path}"
            engine = serving_engine(model, kv_dtype, num_pages=PRESSURE_POOL,
                                    kv_tier=True, **kw)
            warm_up(engine, [prompt])
            with count_calls(serving_plain_versions()) as plain_calls, \
                    timed_dispatches(engine) as times, \
                    tier_watch(engine) as tw:
                reset_launches()
                lone = lone_runs(engine, prompt, NEW, label)
                pools = [t.clone() for t in pool_pages(engine)]
                r, _ = in_flight_pause(engine, prompt, NEW, label)
                launches = dict(rpa.launches)
            if plain_calls:
                fail(f"{label}: plain versions ran on the card: "
                     f"{sorted(set(plain_calls))}")
            ticks = sum(times["ticks"].values())
            mixed = len(times["mixed"]) + len(times["decode"])
            want = {k: 0 for k in launches}
            want[key] = per_layer * LADDER_LAYERS * (mixed + ticks)
            if launches != want:
                fail(f"{label}: kernel launches {launches} != {want}")
            if r.output_ids != lone[0].output_ids:
                fail(f"{label} in flight: tokens differ from the "
                     "uninterrupted run's")
            hold_allocator(label, engine)
            del engine
            torch.cuda.empty_cache()
            # the copy chaos on the reference test's pool
            engine = LlamaServingEngine(model, kv_dtype=kv_dtype,
                                        kv_tier=True, prefix_cache=False,
                                        **kw, **CHAOS_GEOM)
            warm_up(engine, [prompt])
            free0 = engine.alloc.free_pages
            with fault_plan(CHAOS_PLAN), count_calls(
                    serving_plain_versions()) as plain_calls:
                rpa.launches[key] = 0
                reqs = chaos_schedule(engine, Request)
                chaos_launches = rpa.launches[key]
            st = engine.tier.stats()
            got = {k: st[k] for k in CHAOS_STATS}
            lost = [(r.status, r.error) for r in reqs
                    if r.status != "completed" and r.error is None]
            if plain_calls or got != CHAOS_STATS or lost or st["bytes"] \
                    or st["pages"] or engine.alloc.free_pages != free0 \
                    or engine.alloc.double_free_count:
                fail(f"{label} chaos: tier {st} (want {CHAOS_STATS}), lost "
                     f"{lost}, free {engine.alloc.free_pages}/{free0}, "
                     f"plain {sorted(set(plain_calls))}")
            print(f"{label}: lone and in-flight pauses bitwise, pools in "
                  f"place; {tier_line(tw)}; chaos: statuses "
                  f"{[r.status for r in reqs]}, tier {st}", flush=True)
            counts[key] = counts.get(key, 0) + launches[key] + chaos_launches
            runs[path] = dict(outs=[x.output_ids for x in lone], pools=pools)
            del engine
            torch.cuda.empty_cache()
        base = runs["rope-fused"]
        for path in ("fused-kv", "two-op"):
            res = runs[path]
            if res["outs"] != base["outs"] or not all(
                    torch.equal(a, b) for a, b in zip(res["pools"],
                                                      base["pools"])):
                fail(f"pause paths {kv_dtype or 'bf16'} {path}: tokens, pools "
                     "or sidecars differ from the rope-fused path's")
        print(f"pause paths {kv_dtype or 'bf16'}: the three paths' tokens and "
              f"pools and sidecars ({len(base['pools'])} tensors) bitwise "
              f"equal after pauses and resumes", flush=True)
    return counts


# ----------------------------------------------------------------------
# phases 15-15c: speculative decoding
# ----------------------------------------------------------------------

SPEC_K = 4          # phases 15, 15b: the most drafts a verify row carries
SPEC_PATHS_K = 3    # phase 15c
SPEC_BLOCK = 16     # phase 15's prompts: a seeded 16-token block repeated
# phase 15: the oracle re-proposes its last pass's tokens until it has
# this acceptance, at most this many times
SPEC_ORACLE_GOAL, SPEC_ORACLE_PASSES = 0.9, 6


def spec_prompts(vocab):
    """Phase 15's traffic: 8 prompts of 64, 128, ..., 512 tokens, each a
    seeded 16-token block of its own repeated (the prompt-lookup traffic
    the n-gram drafter exists for: code, few-shot scaffolding)."""
    import numpy as np
    rng = np.random.RandomState(15)
    lens = np.linspace(64, 512, 8).astype(int)
    return [rng.randint(0, vocab, SPEC_BLOCK).tolist() * (n // SPEC_BLOCK)
            for n in lens]


class OracleDrafter:
    """Proposes a given run's tokens for the prompt it drafts (``wants``:
    prompt tuple -> tokens)."""

    def __init__(self, wants):
        self.wants = wants
        self.want, self.n = (), 0

    def sync(self, prompt_ids, output_ids):
        self.want = self.wants[tuple(int(t) for t in prompt_ids)]
        self.n = len(output_ids)

    def propose(self, k):
        return list(self.want[self.n:self.n + int(k)])


class GarbageDrafter:
    """Proposes one token, ``k`` times, whatever the history."""

    def __init__(self, bad):
        self.bad = bad

    def sync(self, prompt_ids, output_ids):
        pass

    def propose(self, k):
        return [self.bad] * int(k)


def oracle_of(prompts, outs):
    wants = {tuple(p): list(o) for p, o in zip(prompts, outs)}
    return lambda: OracleDrafter(wants)


@contextlib.contextmanager
def spec_watch(engine):
    """Count ``engine``'s verify dispatches, verify rows and the drafts
    scheduled on them; yields ``{"verify_dispatches", "verify_rows",
    "drafts"}``."""
    seen = {"verify_dispatches": 0, "verify_rows": 0, "drafts": 0}
    dispatch = engine._dispatch_rows

    def on_dispatch(rows, cow=()):
        drafts = [n - 1 for _, _, _, n, _, dec in rows if dec and n > 1]
        seen["verify_dispatches"] += bool(drafts)
        seen["verify_rows"] += len(drafts)
        seen["drafts"] += sum(drafts)
        return dispatch(rows, cow)
    with instance_attrs(engine, _dispatch_rows=on_dispatch):
        yield seen


def spec_run(engine, reqs, label, key="fused_rope", per_layer=2,
             sampled=False):
    """One run of ``reqs`` through ``engine.generate``: every launch of
    ``key`` counted (``per_layer`` a layer a dispatch or tick), no plain
    version called (and, all greedy, nothing sorted), the drafts
    scheduled equal to ``spec_stats()``'s proposed ones, accepted at most
    proposed, the allocator consistent at the end. Returns the run's
    readings."""
    import torch
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import sampling as SM
    layers = engine.model.config.num_hidden_layers
    s0 = engine.spec_stats()
    plain = serving_plain_versions() + [(SM, "gumbel_argmax_ref")] \
        + ([] if sampled else [(torch, "sort")])
    torch.cuda.synchronize()
    with count_calls(plain) as plain_calls, \
            timed_dispatches(engine) as times, spec_watch(engine) as seen:
        reset_launches()
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
        gumbel = SM.launches["gumbel_argmax"]
    s = engine.spec_stats()
    proposed = s["proposed"] - s0["proposed"]
    accepted = s["accepted"] - s0["accepted"]
    if plain_calls:
        fail(f"{label}: plain versions (or a sort) ran on the card: "
             f"{sorted(set(plain_calls))}")
    ticks = sum(times["ticks"].values())
    mixed = len(times["mixed"]) + len(times["decode"])
    want = {k: 0 for k in launches}
    want[key] = per_layer * layers * (mixed + ticks)
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want} ({per_layer} "
             f"x layers x (dispatches + ticks) of {key})")
    if proposed != seen["drafts"] or not 0 <= accepted <= proposed:
        fail(f"{label}: spec_stats proposed {proposed} accepted {accepted}"
             f" against {seen['drafts']} drafts scheduled")
    if any(len(o) != NEW for o in outs) \
            or any(r.status != "completed" for r in reqs):
        fail(f"{label}: statuses {[r.status for r in reqs]}, lengths "
             f"{[len(o) for o in outs]}")
    hold_allocator(label, engine)
    rows = seen["verify_rows"]
    return dict(outs=[list(o) for o in outs], wall=wall, mixed=mixed,
                ticks=ticks, times=times, proposed=proposed,
                accepted=accepted, verify=seen["verify_dispatches"],
                rows=rows, per_row=(rows + accepted) / rows if rows else 0,
                launches=launches[key], gumbel=gumbel, reqs=reqs)


def spec_line(res, ref_outs):
    """What phase 15 prints of one run: dispatches, verify dispatches,
    tokens per verify row, acceptance, mixed dispatch ms, tokens/s and
    the share of tokens equal to ``ref_outs``."""
    n_tok = sum(map(len, res["outs"]))
    eq = sum(a == b for o, ob in zip(res["outs"], ref_outs)
             for a, b in zip(o, ob))
    times = res["times"]
    mixed_ms = 1e3 * sum(times["mixed"]) / max(len(times["mixed"]), 1)
    rate = res["accepted"] / res["proposed"] if res["proposed"] else 0.0
    return (f"dispatches={res['mixed']} ticks={res['ticks']} "
            f"verify_dispatches={res['verify']} verify_rows={res['rows']} "
            f"proposed={res['proposed']} accepted={res['accepted']} "
            f"acceptance={rate:.4f} tokens_per_verify_row="
            f"{res['per_row']:.3f} mixed_dispatch_ms={mixed_ms:.2f} "
            f"(n={len(times['mixed'])}) wall_s={res['wall']:.3f} "
            f"tokens_per_s={n_tok / res['wall']:.1f} "
            f"equal_to_single_steps={eq}/{n_tok}")


def serve_spec(dev, model):
    """Phase 15: Llama-3-8B at full width and depth, bf16, ``max_batch=8``,
    page 16, phase 4's pool, phase 15's prompts (:func:`spec_prompts`),
    32 new tokens each, greedy, four runs on one model: no speculation
    graphed, no speculation with ``decode_ticks=1``, ``spec_k=4`` with the
    n-gram drafter and ``spec_k=4`` with an oracle drafter that proposes
    the single-step run's tokens, then proposes its own last pass's tokens
    until SPEC_ORACLE_GOAL of its drafts are accepted (at most
    SPEC_ORACLE_PASSES passes). Held on every run
    (:func:`spec_run`): #12's launches, no plain call, the drafts
    scheduled equal to the proposed count, accepted at most proposed, the
    allocator consistent, the tokens at phase 4's floors against the
    model's own plain forward; the oracle's run verifies (the n-gram
    drafter proposes only once the history repeats, which random weights
    may never do: then the engine scans as without speculation). Returns
    the launches of #12."""
    import torch
    from paddle_tpu_torch.inference import Request
    prompts = spec_prompts(model.config.vocab_size)
    runs, launches = {}, 0

    def run(engine, name):
        nonlocal launches
        res = spec_run(engine, [Request(p, max_new_tokens=NEW)
                                for p in prompts], f"spec {name}")
        res["floor"] = hold_floor(f"spec {name}", token_gaps(
            model, dev, prompts, res["outs"]))
        runs[name] = res
        launches += res["launches"]
        return res

    for name, kw in (("graphed", {}), ("single", dict(decode_ticks=1)),
                     ("ngram", dict(spec_k=SPEC_K))):
        engine = serving_engine(model, **kw)
        warm_up(engine, prompts)
        run(engine, name)
        del engine
        torch.cuda.empty_cache()
    engine = serving_engine(model, spec_k=SPEC_K, drafter_factory=oracle_of(
        prompts, runs["single"]["outs"]))
    warm_up(engine, prompts)
    res = run(engine, "oracle")
    if not res["verify"]:
        fail("spec oracle: no verify dispatch")
    # after the first near-tie that the card's rounding at another M
    # flips, an oracle's proposals for that request are stale: proposing
    # each pass's own tokens again converges on the engine's own
    for k in range(1, SPEC_ORACLE_PASSES + 1):
        if res["accepted"] >= SPEC_ORACLE_GOAL * res["proposed"]:
            break
        engine._drafter_factory = oracle_of(prompts, res["outs"])
        res = run(engine, f"oracle pass {k}")
    del engine
    torch.cuda.empty_cache()
    print(f"spec: requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={len(prompts) * NEW} "
          f"spec_k={SPEC_K}", flush=True)
    for name, res in runs.items():
        print(f"spec {name}: {spec_line(res, runs['single']['outs'])} "
              f"launches={res['launches']} {res['floor']}", flush=True)
    return launches


@contextlib.contextmanager
def gumbel_rows(engine):
    """Record, for each of ``engine``'s mixed dispatches, its packed
    tokens, rows, whether it is chunk-shaped, and the rows of each
    ``gumbel_argmax`` call in it; yields the list."""
    from paddle_tpu_torch.inference import sampling as S
    seen, inside = [], []
    real, dispatch = S.gumbel_argmax, engine._dispatch_rows

    def counted(scores, *a, **k):
        if inside:
            seen[-1][3].append(scores.shape[0])
        return real(scores, *a, **k)

    def on_dispatch(rows, cow=()):
        chunk = any(n > 1 or not dec for _, _, _, n, _, dec in rows)
        seen.append((sum(n for _, _, _, n, _, _ in rows), len(rows), chunk,
                     []))
        inside.append(1)
        try:
            return dispatch(rows, cow)
        finally:
            inside.pop()
    S.gumbel_argmax = counted
    try:
        with instance_attrs(engine, _dispatch_rows=on_dispatch):
            yield seen
    finally:
        S.gumbel_argmax = real


def serve_spec_sampled(dev, model):
    """Phase 15b: phase 11's graphed rows (greedy, temperature / top-p,
    temperature / top-k, a forcing bias) over phase 4's prompts and
    model, ``spec_k=4``, with an oracle drafter proposing a
    non-speculative run's tokens (the same seeds, single steps) and with
    the n-gram drafter. Held: :func:`spec_run`'s holds; one
    ``gumbel_argmax`` launch and one sort per dispatch that holds a
    sampled row, over every packed token (``[T, V]``) on a chunk-shaped
    dispatch and over the rows (``[R, V]``) on a decode-only one, plus one
    a sampled tick; the forced row obeying; the sampled tokens replayed
    through the plain forward and sampler at the same (seed, position)
    at phase 4's floor. Returns (the launches of #12, of
    ``gumbel_argmax``)."""
    import torch
    prompts = serving_prompts(model.config.vocab_size)
    kinds = tuple(None if k == "constrained" else k for k in SAMPLED_ROWS)
    engine = serving_engine(model, decode_ticks=1)
    warm_up(engine, prompts)
    base = spec_run(engine, sampled_requests(prompts, kinds),
                    "spec sampled, no speculation", sampled=True)
    del engine
    launches, glaunches = base["launches"], base["gumbel"]
    for name, factory in (("oracle", oracle_of(prompts, base["outs"])),
                          ("ngram", None)):
        label = f"spec sampled {name}"
        engine = serving_engine(model, spec_k=SPEC_K,
                                drafter_factory=factory)
        warm_up(engine, prompts)
        reqs = sampled_requests(prompts, kinds)
        with sampled_dispatches(engine) as seen, \
                gumbel_rows(engine) as shapes:
            res = spec_run(engine, reqs, label, sampled=True)
        replays = dict(res["times"]["ticks"])
        want = sum(s for s, _, _ in seen) + replays.get("sampled", 0)
        if res["gumbel"] != want or not want:
            fail(f"{label}: {res['gumbel']} gumbel_argmax launches, want "
                 f"{want} (sampled dispatches and sampled ticks {replays})")
        for (sampled, n_launch, n_sort), (t, r, chunk, calls) \
                in zip(seen, shapes):
            if (n_launch, n_sort) != ((1, 1) if sampled else (0, 0)) \
                    or calls != ([t if chunk else r] if sampled else []):
                fail(f"{label}: a dispatch (sampled={sampled}, T={t}, R={r},"
                     f" chunk-shaped={chunk}) launched gumbel_argmax over "
                     f"{calls} rows and sorted {n_sort} times")
        for i, (kind, o) in enumerate(zip(kinds, res["outs"])):
            if kind == "forced" and set(o) != {FORCED_TOKEN}:
                fail(f"{label}: forced row {i} gave {sorted(set(o))}")
        exact, n_tok = 0, 0
        with plain_serving_paths():
            for i, (r, o) in enumerate(zip(reqs, res["outs"])):
                if kinds[i] is None:
                    continue
                toks, margins = replay_sampled(engine, model, dev, r, o)
                exact += sum(a == b for a, b in zip(toks, o))
                n_tok += len(o)
                for pos, margin, over_r, over_s in margins:
                    print(f"{label}: row {i} token {pos} differs from the "
                          f"plain replay, its margin there {margin:.4f} "
                          f"(over the keep threshold: replay's token "
                          f"{over_r:.4f}, served {over_s:.4f})", flush=True)
        greedy = [(p, o) for p, o, k in zip(prompts, res["outs"], kinds)
                  if k is None]
        floor = hold_floor(label, token_gaps(model, dev, *zip(*greedy)))
        print(f"{label}: {spec_line(res, base['outs'])} sampled_dispatches="
              f"{sum(s for s, _, _ in seen)} gumbel_launches={res['gumbel']}"
              f" gumbel_rows_per_chunk_dispatch="
              f"{sorted({c[0] for *_, ch, c in shapes if ch and c})} "
              f"plain_replay_exact={exact}/{n_tok}; greedy rows {floor}",
              flush=True)
        if exact < EXACT_FLOOR * n_tok:
            fail(f"{label}: only {exact}/{n_tok} sampled tokens are the "
                 f"plain replay's (floor {EXACT_FLOOR})")
        launches += res["launches"]
        glaunches += res["gumbel"]
        del engine
        torch.cuda.empty_cache()
    print(f"spec sampled, no speculation (decode_ticks=1): "
          f"{spec_line(base, base['outs'])}", flush=True)
    return launches, glaunches


def serve_spec_paths(dev):
    """Phase 15c: phase 13c's 4-layer cut through the three attention
    paths, both KV dtypes, ``spec_k=3`` with a garbage drafter (one token
    proposed whatever the history: every draft the model does not emit
    is rejected and its verify row rolled back) over phase 15's prompts:
    :func:`spec_run`'s holds on each path, and the tokens, the pools and
    sidecars and ``spec_stats()`` bit for bit equal across the paths.
    Returns the launches of each path by its launch-count key."""
    import torch
    from paddle_tpu_torch.inference import Request
    cfg, model = llama_model(dev, LADDER_LAYERS)
    prompts = spec_prompts(cfg.vocab_size)
    bad = cfg.vocab_size - 1
    counts = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for path, (kw, per_layer, key) in LADDER.items():
            key += "_q8" if kv_dtype else ""
            label = f"spec paths {kv_dtype or 'bf16'} {path}"
            engine = serving_engine(
                model, kv_dtype, spec_k=SPEC_PATHS_K,
                drafter_factory=lambda: GarbageDrafter(bad), **kw)
            warm_up(engine, prompts)
            res = spec_run(engine, [Request(p, max_new_tokens=NEW)
                                    for p in prompts], label, key,
                           per_layer)
            if not res["verify"] or res["accepted"] >= res["proposed"]:
                fail(f"{label}: {res['verify']} verify dispatches, "
                     f"{res['accepted']} of {res['proposed']} drafts "
                     "accepted: nothing rolled back")
            res["pools"] = [t.clone() for t in pool_pages(engine)]
            res["stats"] = engine.spec_stats()
            counts[key] = res["launches"]
            runs[path] = res
            del engine
            torch.cuda.empty_cache()
        base = runs["rope-fused"]
        for path in ("fused-kv", "two-op"):
            res = runs[path]
            label = f"spec paths {kv_dtype or 'bf16'} {path}"
            if res["outs"] != base["outs"] or res["stats"] != base["stats"]:
                fail(f"{label}: tokens or spec_stats {res['stats']} differ "
                     f"from the rope-fused path's {base['stats']}")
            if not all(torch.equal(a, b) for a, b in zip(res["pools"],
                                                        base["pools"])):
                fail(f"{label}: pools or sidecars differ from the "
                     "rope-fused path's bit for bit")
        print(f"spec paths {kv_dtype or 'bf16'}: the three paths' tokens, "
              f"spec_stats {base['stats']} and pools and sidecars "
              f"({len(base['pools'])} tensors) bitwise equal after "
              f"{base['rows']} verify rows ({base['verify']} dispatches, "
              f"{base['proposed'] - base['accepted']} drafts rolled back); "
              f"launches { {p: r['launches'] for p, r in runs.items()} }",
              flush=True)
    return counts


OBS_STALL_S = 2.0       # phase 16: a stalled dispatch, past the 1 s poll


@contextlib.contextmanager
def dispatch_watch(engine):
    """Phase 16's tap of ``engine``: the mixed dispatches and scans that
    ran, the dispatch shapes used (each one warm-up dispatch with metrics
    on), and the per-token latency samples the engine should take (one a
    decode-only dispatch; a scan's ticks when its tick count was warm
    before it ran); yields ``{"mixed", "scans", "shapes", "tpot"}``."""
    seen = {"mixed": 0, "scans": 0, "shapes": set(), "tpot": 0}
    dispatch, scan = engine._dispatch_rows, engine._decode_scan

    def on_dispatch(rows, cow=()):
        seen["mixed"] += 1
        if not any(n > 1 or not dec for _, _, _, n, _, dec in rows):
            seen["tpot"] += 1
            seen["shapes"].add(engine.max_batch)
        else:
            seen["shapes"].add(engine.chunk_budget)
        return dispatch(rows, cow)

    def on_scan(n):
        warm = ("scan", n) in engine._warmed_keys
        out = scan(n)
        if out:
            seen["scans"] += 1
            seen["tpot"] += n if warm else 0
        return out
    with instance_attrs(engine, _dispatch_rows=on_dispatch,
                        _decode_scan=on_scan):
        yield seen


#: the engine's metric calls a dispatch or scan makes apart from its
#: inline counter updates (phase 16 times them)
METRIC_HOOKS = ("_set_pool_gauges", "_note_perf", "_note_mixed_bytes",
                "_record_shape")


def observed_pass(engine, prompts, traced=False):
    """Phase 13's traffic once through ``engine`` (request 0 by
    ``add_request``, then the rest, then decoding to the end), every
    request traced when ``traced``: returns (requests, wall seconds,
    mean mixed-dispatch host ms, the host ms of the engine's
    ``METRIC_HOOKS`` per dispatch or scan)."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.observability import tracing as otracing
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    if traced:
        for r in reqs:
            r._trace = otracing.mint()
    spent = [0.0]

    def timed(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        return wrapper
    hooks = {n: timed(getattr(engine, n)) for n in METRIC_HOOKS}
    torch.cuda.synchronize()
    with timed_dispatches(engine) as times, instance_attrs(engine, **hooks):
        t0 = time.perf_counter()
        engine.add_request(reqs[0])
        for r in reqs[1:]:
            engine.add_request(r)
        while not all(r.done for r in reqs):
            engine.decode_many(NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mixed = times["mixed"] + times["decode"]
    calls = len(mixed) + len(times["scan"])
    return (reqs, wall, 1e3 * sum(mixed) / max(len(mixed), 1),
            1e3 * spent[0] / max(calls, 1))


def compile_seen():
    """What the compile watcher counted so far in this process: loads by
    library, captures by graph set, builds, cache hits and misses."""
    from paddle_tpu_torch.observability import metrics as om
    reg = om.default_registry()
    out = {}
    m = reg.get("paddle_tpu_xla_compile_total")
    if m is not None:
        out["compiles"] = {v[0]: int(leaf.value) for v, leaf in m.samples()}
    for name in ("paddle_tpu_xla_backend_compile_total",
                 "compile_cache_hit_total", "compile_cache_miss_total"):
        m = reg.get(name)
        out[name] = 0 if m is None else int(m.value)
    return out


def check_warm_pages(engine, label):
    """Phase 16's page check: a request paused into the host tier, both
    dispatch shapes warmed up again (#12's write launch, the trash page
    put back after), then every page of every pool and scale bitwise as
    before (the cached prefix pages among them) and the paused host copy
    CRC-equal to its export. The paused request is cancelled after."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.inference.kv_tier import _page_crcs
    prefix, prompts = prefix_traffic(engine.model.config.vocab_size)
    parked = Request(prompts[3], max_new_tokens=4)
    engine.add_request(parked)
    with engine._lock:
        engine._pause(parked)
    if parked.status != "paused":
        fail(f"{label}: the request was not paused ({parked.status})")
    ent = engine.tier._seqs[parked._tier_key]
    pools = pool_pages(engine)
    before = [t.clone() for t in pools]
    cached = engine.prefix.pages
    keys = set(engine._warmed_keys)
    engine._warmed_keys.clear()
    with count_calls(serving_plain_versions()) as plain_calls:
        warmed = [engine._warm_mixed(t) for t in (engine.chunk_budget,
                                                  engine.max_batch)]
        torch.cuda.synchronize()
    engine._warmed_keys |= keys
    same = [torch.equal(b, a) for b, a in zip(before, pools)]
    host = _page_crcs(ent.arrays, ent.n_pages) == ent.crcs
    print(f"{label}: warm-up of both shapes ({warmed}) with {cached} "
          f"cached prefix pages and a request of {ent.n_pages} pages "
          f"paused to the host: every page bitwise over {len(pools)} pools "
          f"{all(same)}, the host copy CRC-equal {host}", flush=True)
    if not (all(warmed) and all(same) and host) or plain_calls:
        fail(f"{label}: the warm-up changed pages (tensors "
             f"{[i for i, x in enumerate(same) if not x]}), the "
             f"host copy (CRC equal {host}), or ran plain versions "
             f"{sorted(set(plain_calls))}")
    engine.cancel(parked)


def serve_observed(dev, model):
    """Phase 16 (see the module docstring): the engine with metrics on
    over phase 13's model and traffic, held against its own records, the
    CPU schedule's values and a metrics-off engine; then the fatal path,
    the watchdog and the restarted engine's prewarm. Returns #12's
    launches over the phase's runs (the path's kernel, 2 a layer a
    dispatch or tick)."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.observability import compile_watch as ocw
    from paddle_tpu_torch.observability import flight_recorder as ofr
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.observability import trace as otrace
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    label = "observed"
    whole_run = compile_seen()
    prefix, prompts = prefix_traffic(model.config.vocab_size)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    env0 = {k: os.environ.get(k) for k in ("PADDLE_TPU_METRICS",
                                           "PADDLE_TPU_SHAPE_REGISTRY")}
    launches = 0
    try:
        os.environ["PADDLE_TPU_SHAPE_REGISTRY"] = os.path.join(
            tmp, "shapes.json")
        ocw._shape_registry = None
        om.default_registry().clear()
        otrace.clear()
        engine = serving_engine(model, prefix_cache=True,
                                num_pages=PREFIX_POOL, kv_tier=True)
        reg = om.default_registry()
        stats0 = engine.prefix.stats()
        with count_calls(serving_plain_versions()) as plain_calls, \
                dispatch_watch(engine) as seen, \
                pool_watch(engine) as pages:
            reset_launches()
            reqs, _, _, _ = observed_pass(engine, prompts, traced=True)
            launches += rpa.launches["fused_rope"]
        if plain_calls:
            fail(f"{label}: plain versions ran on the card: "
                 f"{sorted(set(plain_calls))}")
        on_run = compile_seen()
        outs = [list(r.output_ids) for r in reqs]
        cache = {k: v - stats0[k] for k, v in engine.prefix.stats().items()
                 if k in ("lookups", "hits", "saved_tokens")}

        def value(name):
            m = reg.get(name)
            return None if m is None else m.value
        got = {"admitted": value("serving_requests_admitted_total"),
               "completed": value("serving_requests_completed_total"),
               "generated": value("serving_generated_tokens_total"),
               "prefill": value("serving_prefill_tokens_total"),
               "lookups": value("serving_prefix_cache_lookup_total"),
               "hits": value("serving_prefix_cache_hit_total"),
               "saved": value("serving_prefix_saved_prefill_tokens_total"),
               "ttft": reg.get("serving_ttft_seconds").count,
               "tpot": reg.get("serving_token_latency_seconds").count}
        cold = len(prompts[0]) + sum(PREFIX_SUFFIXES[1:])
        want = {"admitted": 8, "completed": 8, "generated": 8 * NEW,
                "prefill": cold, "lookups": 8, "hits": 7,
                "saved": 7 * PREFIX_TOKENS, "ttft": 8, "tpot": seen["tpot"]}
        own = {"generated": sum(map(len, outs)), "prefill": pages["prefill"],
               "lookups": cache["lookups"], "hits": cache["hits"],
               "saved": cache["saved_tokens"]}
        events = [ev["name"] for ev in otrace.get_events()]
        spans = {n: events.count(n) for n in (
            "serving.mixed_step", "serving.decode_scan",
            "serving.first_token")}
        want_spans = {"serving.mixed_step": seen["mixed"],
                      "serving.decode_scan": seen["scans"],
                      "serving.first_token": 8}
        print(f"{label}: counters {got} (want {want}; the engine's own "
              f"records {own}); spans {spans} (want {want_spans}); "
              f"warm-up dispatches {engine._warm_dispatches} (dispatch "
              f"shapes used {sorted(seen['shapes'])}); "
              f"mixed_hbm_bytes {value('serving_mixed_hbm_bytes'):.0f}",
              flush=True)
        warm_want = len(seen["shapes"])
        if got != want or any(got[k] != v for k, v in own.items()) \
                or spans != want_spans \
                or engine._warm_dispatches != warm_want \
                or any(r.status != "completed" for r in reqs):
            fail(f"{label}: counters {got} != {want} or the engine's "
                 f"records {own}, spans {spans} != {want_spans}, warm-ups "
                 f"{engine._warm_dispatches} != {warm_want} (one a "
                 f"dispatch shape used), statuses "
                 f"{[r.status for r in reqs]}")
        check_warm_pages(engine, label)
        hold_allocator(label, engine)
        recorded = ocw.shape_registry().lookup(engine._shape_key)
        _, wall_on, ms_on, hooks_on = observed_pass(engine, prompts)
        engine.close()
        del engine
        torch.cuda.empty_cache()

        os.environ["PADDLE_TPU_METRICS"] = "0"
        om.default_registry().clear()
        otrace.clear()
        off = serving_engine(model, prefix_cache=True, num_pages=PREFIX_POOL,
                             kv_tier=True)
        with count_calls(serving_plain_versions()) as plain_calls:
            reset_launches()
            off_reqs, _, _, _ = observed_pass(off, prompts)
            _, wall_off, ms_off, hooks_off = observed_pass(off, prompts)
            launches += rpa.launches["fused_rope"]
        off_outs = [list(r.output_ids) for r in off_reqs]
        empty = om.default_registry().collect() == [] \
            and otrace.get_events() == []
        print(f"{label} metrics off: tokens bitwise the metrics-on run's "
              f"{off_outs == outs}, registry and spans empty {empty}, "
              f"warm-up dispatches {off._warm_dispatches}", flush=True)
        if off_outs != outs or not empty or off._warm_dispatches \
                or plain_calls:
            fail(f"{label}: metrics off changed tokens ({off_outs != outs}),"
                 f" registered or recorded (empty {empty}), warmed "
                 f"{off._warm_dispatches} or ran plain versions "
                 f"{sorted(set(plain_calls))}")
        off.close()
        del off
        torch.cuda.empty_cache()
        if env0["PADDLE_TPU_METRICS"] is None:
            del os.environ["PADDLE_TPU_METRICS"]
        else:
            os.environ["PADDLE_TPU_METRICS"] = env0["PADDLE_TPU_METRICS"]
        n_tok = len(prompts) * NEW
        print(f"{label}: second pass tokens_per_s={n_tok / wall_on:.1f} "
              f"with metrics, {n_tok / wall_off:.1f} without; mixed "
              f"dispatch host ms {ms_on:.3f} with, {ms_off:.3f} without "
              f"({ms_on - ms_off:.3f} apart); the engine's metric calls "
              f"({', '.join(METRIC_HOOKS)}) {hooks_on:.4f} host ms a "
              f"dispatch or scan with metrics, {hooks_off:.4f} without "
              f"(the metrics add {hooks_on - hooks_off:.4f})", flush=True)

        # the fatal path, the watchdog, the restarted engine's prewarm
        om.default_registry().clear()
        ofr.install(log_dir=tmp)
        engine = serving_engine(model, prefix_cache=True,
                                num_pages=PREFIX_POOL)
        done = engine.prewarm()
        want_recipe = (sorted(recorded.get("mixed", ())),
                       sorted(recorded.get("scan", ())))
        if (done["mixed"], done["scan"]) != want_recipe \
                or not done["mixed"] or not done["scan"] \
                or engine._warm_dispatches != len(done["mixed"]) \
                + len(done["scan"]):
            fail(f"{label}: a restarted engine's prewarm() warmed {done} "
                 f"({engine._warm_dispatches} warm-ups), the registry "
                 f"recorded {recorded}")
        r = Request(prompts[1], max_new_tokens=2)
        engine.add_request(r)

        def explode(*a, **k):
            raise RuntimeError("observed: forced fault in step")
        with instance_attrs(engine, _mixed_forward=explode):
            try:
                engine.step()
            except RuntimeError as e:
                if "forced fault" not in str(e):
                    raise
            else:
                fail(f"{label}: the forced fault in step did not raise")
        root = os.path.join(tmp, "postmortem")
        bundles = sorted(os.listdir(root)) if os.path.isdir(root) else []
        env_doc = {}
        if len(bundles) == 1:
            with open(os.path.join(root, bundles[0], "env.json")) as f:
                env_doc = json.load(f)
            for part in ("trace.json", "metrics.json"):
                with open(os.path.join(root, bundles[0], part)) as f:
                    json.load(f)
        print(f"{label}: forced fault in step: {len(bundles)} post-mortem "
              f"bundle(s), reason {env_doc.get('reason')!r}, "
              f"{len(env_doc.get('memory_stats') or {})} memory_stats keys,"
              f" mem_get_info {env_doc.get('mem_get_info')}", flush=True)
        if len(bundles) != 1 or env_doc.get("reason") != "serving.step" \
                or not env_doc.get("memory_stats"):
            fail(f"{label}: the forced fault left {bundles}, env {env_doc}")
        engine.close()
        del engine
        torch.cuda.empty_cache()
        engine = serving_engine(model, prefix_cache=True,
                                num_pages=PREFIX_POOL, decode_ticks=1)
        engine.prewarm([engine.chunk_budget, engine.max_batch], [])
        r = Request(prompts[2], max_new_tokens=NEW)
        engine.add_request(r)
        engine.step()
        # the watchdog arms on 8 warm samples: a 50 ms floor over 1 ms
        # dispatches, so the stall fires at its first poll (1 s)
        engine._dispatch_times.clear()
        engine._dispatch_times.extend([0.001] * 16)
        engine.stuck_min_timeout = 0.05
        before = reg_value = 0.0
        fam = om.default_registry().get("watchdog_timeouts_total")
        if fam is not None and fam.peek("serving.decode") is not None:
            before = fam.peek("serving.decode").value
        forward = engine._mixed_forward

        def stalled(*a, **k):
            time.sleep(OBS_STALL_S)
            return forward(*a, **k)
        with instance_attrs(engine, _mixed_forward=stalled):
            engine.step()
        fam = om.default_registry().get("watchdog_timeouts_total")
        reg_value = fam.labels("serving.decode").value if fam else 0.0
        print(f"{label}: a dispatch stalled {OBS_STALL_S}s under the "
              f"watchdog: watchdog_timeouts_total {before} -> {reg_value}",
              flush=True)
        if reg_value != before + 1:
            fail(f"{label}: the stalled dispatch counted "
                 f"{reg_value - before} watchdog timeouts, not 1")
        while not r.done:
            engine.step()
        engine.close()
        del engine
        torch.cuda.empty_cache()
        print(f"{label}: the compile watcher before this phase "
              f"{whole_run}; over its metrics-on run {on_run}", flush=True)
        saw = {**whole_run.get("compiles", {}), **on_run.get("compiles", {})}
        if not any(k.startswith("kernel:") for k in saw) \
                or not on_run.get("compiles", {}).get("serving.decode_tick"):
            fail(f"{label}: the compile watcher saw no library load or no "
                 f"tick capture of the fresh engine: {whole_run}, {on_run}")
    finally:
        ofr.uninstall()
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ocw._shape_registry = None
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ----------------------------------------------------------------------
# phase 17: the serving stack over the engine
# ----------------------------------------------------------------------

STACK_TTL = 30.0      # 17a's membership TTL: past any engine build's hold
#                       of the cross-engine dispatch lock (its prewarm)
STACK_WORKER_TTL = 20.0   # 17b's: worker heartbeats ride their own process
STACK_BURST = 16      # decode ticks a replica's worker-loop tick runs
STACK_FLOOD = 4       # 17a: low-tenant requests, every one shed with 429
STACK_SAMPLED = {"temperature": 0.8, "top_p": 0.9, "seed": 1717}
STACK_SECOND = 4      # 17a: the second wave, under the profiler window
STACK_KILL_AT = 2     # output tokens a victim's request has when killed
STACK_NEW2 = 2 * NEW  # 17b: the second wave's, decoding through the window


def http_call(port, path, body=None, headers=None, timeout=600):
    """(status, headers, parsed JSON body) of one request to the
    front door on ``127.0.0.1:port``."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"null")


def sse_call(port, body, headers=None, timeout=600):
    """POST a streamed completion; returns (status, the ``data:`` chunks
    parsed, whether the stream ended in ``[DONE]``, seconds to the first
    chunk)."""
    import socket
    payload = json.dumps(body).encode()
    hdrs = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    t0 = time.perf_counter()
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        sock.sendall(
            f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n{hdrs}"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        rf = sock.makefile("rb")
        status = int(rf.readline().split()[1])
        while rf.readline().strip():
            pass
        chunks, done, first = [], False, None
        for line in rf:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            if line == b"data: [DONE]":
                done = True
                break
            chunks.append(json.loads(line[len(b"data: "):]))
        rf.close()
        return status, chunks, done, first
    finally:
        sock.close()


def metric_values(snapshot, name):
    """``{labels: value}`` of family ``name`` in a registry snapshot."""
    fam = next((e for e in snapshot if e["name"] == name), None)
    if fam is None:
        return {}
    return {tuple(s["labels"]): s.get("value") for s in fam["samples"]}


def metric_deltas(before, after, names):
    """Per family and labels, what ``after`` adds to ``before``."""
    out = {}
    for name in names:
        b, a = metric_values(before, name), metric_values(after, name)
        out[name] = {k: v - b.get(k, 0.0) for k, v in a.items()
                     if v != b.get(k, 0.0)}
    return out


def stack_engine(model, counts, built):
    """Phase 17a's replica factory: :func:`serving_engine` over the shared
    model with the prefix cache on and phase 13's pool, prewarmed (both
    dispatch shapes, every tick mode's graph captured) before it serves.
    Its forward and tick are tapped before the prewarm: ``counts`` gets
    the eager forwards (a capture's own pass is not a launch), the tick
    graphs' replays, and of both those that ran the sampler; ``built``
    every engine made."""
    import torch
    lock = counts["lock"]

    def build():
        engine = serving_engine(model, prefix_cache=True,
                                num_pages=PREFIX_POOL)
        fwd, run = engine._mixed_forward, engine._run_tick

        def counted_forward(*a):
            if not torch.cuda.is_current_stream_capturing():
                sample = a[15] if len(a) > 15 else None
                with lock:
                    counts["forwards"] += 1
                    counts["sampled"] += bool(sample is not None
                                              and sample[1])
            return fwd(*a)

        def counted_tick(mode):
            if engine._graphs.cuda:     # a replay (on the CPU the tick's
                with lock:              # forward runs, and is counted)
                    counts["ticks"] += 1
                    counts["sampled"] += mode == "sampled"
            return run(mode)
        engine._mixed_forward = counted_forward
        engine._run_tick = counted_tick
        engine.prewarm([engine.chunk_budget, engine.max_batch],
                       [engine.decode_ticks])
        built.append(engine)
        return engine
    return build


def live_prompts(engine):
    """The prompts (tuples) of ``engine``'s live requests with their
    output lengths, read from another thread."""
    for _ in range(100):
        try:
            return {tuple(int(t) for t in r.prompt_ids): len(r.output_ids)
                    for r in list(engine._live.values()) if not r.done}
        except RuntimeError:        # the dict changed under the read
            time.sleep(0.001)
    return {}


def card_memory():
    """``torch.cuda.mem_get_info()`` in GiB, read holding the capture
    lock (another thread may be capturing a tick graph)."""
    import torch
    from paddle_tpu_torch.ops._graphs import CAPTURE_LOCK
    with CAPTURE_LOCK:
        free, total = torch.cuda.mem_get_info()
    return f"{(total - free) / 2**30:.2f} of {total / 2**30:.2f} GiB used"


def serve_stack(dev, model):
    """Phase 17a (see the module docstring): a ``ServingCluster`` of two
    in-process ``EngineReplica``s over phase 13's model behind a
    ``ServingFrontend`` with a two-tenant ``QosGate``; phase 13's traffic
    over HTTP (one streamed), one sampled request and a shed flood; one
    replica killed mid-run and replaced; a second wave under
    ``/debug/profile``; ``/readyz`` while both drain. Returns #12's
    launches over the phase."""
    import tempfile
    import threading
    import torch
    from paddle_tpu_torch.inference import (QosGate, ServingCluster,
                                            ServingFrontend, Tenant)
    from paddle_tpu_torch.observability import export as oexport
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.ops import sampling as SM
    label = "stack in-process"
    t_phase = time.perf_counter()
    layers = model.config.num_hidden_layers
    _, prompts = prefix_traffic(model.config.vocab_size)
    counts = {"lock": threading.Lock(), "forwards": 0, "ticks": 0,
              "sampled": 0}
    built, creqs, failed_over, t_kill = [], [], [], []
    names = ("router_failovers_total", "replica_deaths_total",
             "router_replicas_replaced_total",
             "serving_prefix_cache_hit_total",
             "serving_tenant_admitted_total", "serving_tenant_shed_total",
             "frontend_requests_total")
    before = oexport.json_snapshot()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stack_")
    gate = QosGate([Tenant("prem", tier="premium"),
                    Tenant("flood", tier="batch", rate=1, burst=1)])
    # the low tenant's bucket starts drained: its flood is all shed
    gate.settle(gate.admit("flood"), completed_tokens=1000)
    with count_calls(serving_plain_versions()
                     + [(SM, "gumbel_argmax_ref")]) as plain_calls:
        reset_launches()
        cluster = ServingCluster(stack_engine(model, counts, built),
                                 num_replicas=2, store_path=tmp,
                                 ttl=STACK_TTL, burst=STACK_BURST)
        fe = None
        try:
            cluster.start()
            submit, failover = cluster.submit, cluster._failover

            def recorded_submit(*a, **kw):
                creq = submit(*a, **kw)
                creqs.append(creq)
                return creq

            def recorded_failover(creq, dead_rid):
                failed_over.append((creq, time.perf_counter()))
                return failover(creq, dead_rid)
            cluster.submit = recorded_submit
            cluster._failover = recorded_failover
            fe = ServingFrontend(cluster=cluster, qos=gate)
            port = fe.start(port=0).port
            t_built = time.perf_counter() - t_phase
            results, threads = {}, []
            prem = {"X-Tenant": "prem"}

            def post(key, body):
                t0 = time.perf_counter()
                results[key] = http_call(port, "/v1/completions", body,
                                         prem) + (time.perf_counter() - t0,)

            def stream(key, body):
                results[key] = sse_call(port, body, prem)
            stream_i = 3
            t0 = time.perf_counter()
            for i, p in enumerate(prompts):
                body = {"prompt": p, "max_tokens": NEW, "temperature": 0}
                if i == stream_i:
                    body["stream"] = True
                threads.append(threading.Thread(
                    target=stream if i == stream_i else post,
                    args=(i, body)))
            threads.append(threading.Thread(target=post, args=(
                "sampled", {"prompt": prompts[0][:96], "max_tokens": NEW,
                            **STACK_SAMPLED})))
            for th in threads:
                th.start()
            floods = [http_call(port, "/v1/completions",
                                {"prompt": prompts[0][:8], "max_tokens": 4},
                                {"X-Tenant": "flood"})
                      for _ in range(STACK_FLOOD)]
            # the victim: the replica not holding the streamed request,
            # once a request of its own is mid-decode
            victim = None
            deadline = time.monotonic() + 300
            while victim is None and time.monotonic() < deadline:
                lives = {rid: live_prompts(rep.engine)
                         for rid, rep in cluster.replicas().items()}
                for rid, live in lives.items():
                    if tuple(prompts[stream_i]) in live:
                        continue
                    if any(n >= STACK_KILL_AT for n in live.values()):
                        victim = rid
                time.sleep(0.005)
            if victim is None:
                fail(f"{label}: no replica was mid-request within 300 s")
            t_kill.append(time.perf_counter())
            cluster.replicas()[victim].kill()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
            peak_mem = card_memory()
            # the replacement (the monitor rebuilds the victim)
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and not (
                    cluster._m["replaced"].value
                    - metric_values(before, "router_replicas_replaced_total"
                                    ).get((), 0.0) >= 1
                    and all(r.ready() for r in cluster.replicas().values())):
                time.sleep(0.02)
            # a second wave under a profiler window
            second, waves = {}, []

            def post2(key, body):
                second[key] = http_call(port, "/v1/completions", body, prem)
            for i, p in enumerate(prompts[:STACK_SECOND]):
                waves.append(threading.Thread(target=post2, args=(i, {
                    "prompt": p, "max_tokens": NEW, "temperature": 0})))
            for th in waves:
                th.start()
            time.sleep(0.2)
            p_status, _, bundle = http_call(port, "/debug/profile?seconds=1")
            for th in waves:
                th.join(timeout=600)
            for rep in cluster.replicas().values():
                rep.begin_drain()
            ready_status, _, _ = http_call(port, "/readyz")
            deaths = {rid: len(st.deaths)
                      for rid, st in cluster._restarts.items() if st.deaths}
        finally:
            if fe is not None:
                fe.stop()
            cluster.stop()
        launches = dict(rpa.launches)
        gumbel = SM.launches["gumbel_argmax"]
    after = oexport.json_snapshot()
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    # the traffic's results
    bad = {k: r[0] for k, r in list(results.items()) + list(second.items())
           if r[0] != 200}
    if bad or len(results) != len(prompts) + 1 \
            or len(second) != STACK_SECOND:
        fail(f"{label}: statuses {bad}, results {sorted(map(str, results))}")
    s_status, chunks, done, s_first = results[stream_i]
    s_toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    outs = [results[i][2]["choices"][0]["token_ids"] if i != stream_i
            else s_toks for i in range(len(prompts))]
    outs2 = [second[i][2]["choices"][0]["token_ids"]
             for i in range(STACK_SECOND)]
    sampled = results["sampled"][2]["choices"][0]["token_ids"]
    if not done or len(s_toks) != NEW \
            or any(len(o) != NEW for o in outs + outs2 + [sampled]) \
            or any(not 0 <= t < model.config.vocab_size for t in sampled):
        fail(f"{label}: stream done={done} ({len(s_toks)} tokens), lengths "
             f"{[len(o) for o in outs + outs2]}, sampled {sampled}")
    flood_codes = [(f[0], f[1].get("Retry-After"),
                    (f[2] or {}).get("error", {}).get("type"))
                   for f in floods]
    if any(c != (429, c[1], "rate_limit_exceeded") or not c[1]
           or int(c[1]) < 1 for c in flood_codes):
        fail(f"{label}: the flood was not shed with 429 and Retry-After: "
             f"{flood_codes}")
    # #12: two a layer an eager forward or a tick; the sampler once a
    # sampled forward or tick
    want = {k: 0 for k in launches}
    want["fused_rope"] = 2 * layers * (counts["forwards"] + counts["ticks"])
    if launches != want:
        fail(f"{label}: kernel launches {launches} != {want} (2 x layers x "
             f"({counts['forwards']} forwards + {counts['ticks']} ticks))")
    if gumbel != counts["sampled"] or not counts["sampled"]:
        fail(f"{label}: gumbel_argmax launched {gumbel} times for "
             f"{counts['sampled']} sampled forwards and ticks")
    # the counters against the traffic
    d = metric_deltas(before, after, names)
    fo = sum(d["router_failovers_total"].values())
    hits = sum(d["serving_prefix_cache_hit_total"].values())
    own_hits = sum(e.prefix.stats()["hits"] for e in built)
    admitted = d["serving_tenant_admitted_total"]
    shed = d["serving_tenant_shed_total"]
    n_prem = len(prompts) + 1 + STACK_SECOND
    print(f"{label}: counters router_failovers_total={fo} (requests failed "
          f"over {len(failed_over)}), replica_deaths_total="
          f"{sum(d['replica_deaths_total'].values())}, "
          f"router_replicas_replaced_total="
          f"{sum(d['router_replicas_replaced_total'].values())}, "
          f"serving_prefix_cache_hit_total={hits} (the engines' own "
          f"{own_hits}), tenant admitted {admitted} shed {shed}, frontend "
          f"{d['frontend_requests_total']}; deaths by replica {deaths}; "
          f"engines built {len(built)}", flush=True)
    if fo != len(failed_over) or not failed_over \
            or any(c.status != "completed" for c, _ in failed_over):
        fail(f"{label}: failovers {fo} != {len(failed_over)} recorded, or "
             f"none, or one not completed")
    if sum(d["replica_deaths_total"].values()) != 1 \
            or sum(d["router_replicas_replaced_total"].values()) != 1 \
            or deaths != {victim: 1} or len(built) != 3:
        fail(f"{label}: a replacement besides the forced one: deaths "
             f"{deaths}, engines built {len(built)}")
    if hits != own_hits or not hits:
        fail(f"{label}: prefix hits {hits} != the engines' {own_hits}")
    if admitted != {("prem",): float(n_prem), ("flood",): 1.0} \
            or shed != {("flood",): float(STACK_FLOOD)}:
        fail(f"{label}: tenants admitted {admitted}, shed {shed} (want prem "
             f"{n_prem}, flood 1 then {STACK_FLOOD} shed)")
    if ready_status != 503:
        fail(f"{label}: /readyz answered {ready_status} while every "
             "replica drained")
    att = [e for e in bundle.get("traceEvents", [])
           if e.get("ph") == "X" and ("attention_tc" in e.get("name", "")
                                      or "ragged_attention_kernel"
                                      in e.get("name", ""))]
    prof = (bundle.get("capture") or {}).get("profiler", {}).get("router")
    if p_status != 200 or not prof or not prof.get("ok") or not att:
        fail(f"{label}: /debug/profile {p_status}, profiler {prof}, "
             f"{len(att)} attention records")
    floor = hold_floor(label, token_gaps(model, dev, prompts + [
        p for p in prompts[:STACK_SECOND]], outs + outs2))
    ttft = sorted(c.request.ttft for c in creqs
                  if c.request is not None and c.request.ttft is not None)
    walls = {id(c): c for c, _ in failed_over}
    fo_wall = [results[i][3] for i, p in enumerate(prompts)
               if i != stream_i and any(
                   list(c.prompt_ids) == p for c in walls.values())]
    other = [results[i][3] for i, p in enumerate(prompts)
             if i != stream_i and not any(
                 list(c.prompt_ids) == p for c in walls.values())]
    detect = failed_over[0][1] - t_kill[0]
    n_tok = NEW * (len(prompts) + 1)
    print(f"{label}: {card_line()}; engines built in {t_built:.1f} s; "
          f"wave 1 {len(prompts)} greedy (1 streamed) + 1 sampled, "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s "
          f"(a replica killed mid-run); TTFT ms median "
          f"{1e3 * ttft[len(ttft) // 2]:.1f} max {1e3 * ttft[-1]:.1f} "
          f"(engine, {len(ttft)} attempts); stream first chunk "
          f"{1e3 * s_first:.1f} ms; failover: {victim} killed, death "
          f"handled {1e3 * detect:.1f} ms later, failed-over requests' "
          f"wall {sum(fo_wall) / max(len(fo_wall), 1):.3f} s against "
          f"{sum(other) / max(len(other), 1):.3f} s for the rest (added "
          f"{sum(fo_wall) / max(len(fo_wall), 1) - sum(other) / max(len(other), 1):.3f} s); "
          f"card memory at the peak {peak_mem}; profile window "
          f"{len(att)} attention records, {prof.get('device_events')} "
          f"device records; forwards {counts['forwards']} ticks "
          f"{counts['ticks']} sampled {counts['sampled']} launches "
          f"{launches['fused_rope']}; {floor}; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return launches["fused_rope"]


def stack_spec(cfg):
    """Phase 17b's worker spec: Llama-3-8B (``cfg``) from seed 0 in bf16
    on the card behind phase 13's engine geometry."""
    return {"model": {"kind": "llama", "seed": 0,
                      "config": dataclasses.asdict(cfg),
                      "dtype": "bfloat16"},
            "engine": {"max_batch": 8, "page_size": 16,
                       "num_pages": PREFIX_POOL}}


def worker_memory():
    """``{pid: used MiB}`` of the processes on the card (``nvidia-smi``)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    out = {}
    for line in res.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            out[int(parts[0])] = parts[1]
    return out


def device_spans_ms(bundle):
    """``{pid: ms}`` from a capture's first device record's start to its
    last one's end, each process's."""
    first, last = {}, {}
    for e in bundle.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("tid") == "device":
            pid = e["pid"]
            first[pid] = min(first.get(pid, e["ts"]), e["ts"])
            last[pid] = max(last.get(pid, 0.0), e["ts"] + e["dur"])
    return {pid: round((last[pid] - first[pid]) / 1e3, 1) for pid in first}


def stop_workers(cluster):
    """Stop the supervisor, the workers' clean exits side by side, then
    the cluster; SIGKILL any worker process still running."""
    import threading
    cluster._stop.set()
    if cluster._monitor_thread is not None:
        cluster._monitor_thread.join(timeout=5.0)
    stoppers = [threading.Thread(target=rep.stop)
                for rep in cluster.replicas().values()]
    for th in stoppers:
        th.start()
    for th in stoppers:
        th.join(timeout=60.0)
    cluster.stop()
    for rep in cluster.replicas().values():
        p = rep._proc
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=30)


def serve_stack_workers(dev, model):
    """Phase 17b (see the module docstring): a ``ServingCluster`` of two
    ``SubprocessReplica``s, each building Llama-3-8B from seed 0 on the
    card, rpc over the native ``TCPStore`` and ``FileStore`` membership;
    phase 13's traffic with one worker SIGKILLed mid-request; the warm
    replacement; the one-pane scrape; a cluster-wide profile capture."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch.inference import ServingCluster
    from paddle_tpu_torch.inference.replica_worker import weights_digest
    label = "stack workers"
    t_phase = time.perf_counter()
    if not native.available():
        from paddle_tpu_torch.native import build as nbuild
        fail(f"{label}: the native TCP store did not build or load: "
             f"{nbuild.load_error()}")
    _, prompts = prefix_traffic(model.config.vocab_size)
    digest = weights_digest(model)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    log_dir = os.path.join(tmp, "logs")
    cluster = ServingCluster(
        engine_spec=stack_spec(model.config), num_replicas=2,
        store_path=os.path.join(tmp, "members"), ttl=STACK_WORKER_TTL,
        burst=STACK_BURST, spawn_grace=600.0, log_dir=log_dir,
        subprocess_env={"PADDLE_TPU_SHAPE_REGISTRY":
                        os.path.join(tmp, "shapes.json"),
                        # the workers' compile cache starts empty: the
                        # first two build the serving path's kernels
                        # (a cold start), the replacement finds them built
                        "PADDLE_TPU_KERNEL_BUILD_DIR":
                        os.path.join(tmp, "kernels"),
                        "PADDLE_TPU_TRACE_FLUSH": "0.5"})
    try:
        cluster.start()
        reps = cluster.replicas()
        deadline = time.monotonic() + 600
        while not all(r.ready() for r in reps.values()):
            if time.monotonic() > deadline or any(
                    r._proc.poll() is not None for r in reps.values()):
                logs = {f: open(os.path.join(log_dir, f)).read()[-2000:]
                        for f in sorted(os.listdir(log_dir))
                        if f.endswith(".log")}
                fail(f"{label}: the workers did not come up: {logs}")
            time.sleep(0.1)
        t_up = time.perf_counter() - t_phase
        cold = {rid: r.restart_ttft for rid, r in reps.items()}
        cold_cache = {rid: r.cache_stats for rid, r in reps.items()}
        mem_up = worker_memory()
        logged = {}
        for f in sorted(os.listdir(log_dir)):
            if not f.endswith(".log"):
                continue
            for line in open(os.path.join(log_dir, f)):
                if "weights_sha256=" in line:
                    logged[f] = line.split("weights_sha256=")[1].strip()
        if set(logged.values()) != {digest} or len(logged) != 2:
            fail(f"{label}: worker weights {logged} differ from the "
                 f"parent's {digest}")
        # traffic, one worker SIGKILLed once a request of its own decodes
        t0 = time.perf_counter()
        creqs = [cluster.submit(p, max_new_tokens=NEW) for p in prompts]
        deadline = time.monotonic() + 300
        vid = None
        while vid is None:
            vid = next((c.replica_id for c in creqs if not c.done
                        and len(c.partial_output()) >= STACK_KILL_AT), None)
            if vid is None and time.monotonic() > deadline:
                fail(f"{label}: no request was mid-decode within 300 s")
            time.sleep(0.005)
        victim = reps[vid]
        proc0 = victim._proc
        victim.kill()
        outs = [c.result(timeout=600) for c in creqs]
        wall = time.perf_counter() - t0
        if proc0.wait(timeout=60) != -9:
            fail(f"{label}: the victim exited {proc0.returncode}, not by "
                 "SIGKILL")
        if any(c.status != "completed" for c in creqs) \
                or any(len(o) != NEW for o in outs):
            fail(f"{label}: statuses {[c.status for c in creqs]}")
        n_failed_over = sum(c.failovers > 0 for c in creqs)
        routed = {rid: sum(c.replica_id == rid for c in creqs)
                  for rid in reps}
        deadline = time.monotonic() + 600
        while not (victim._proc is not proc0 and victim.ready()):
            if time.monotonic() > deadline:
                fail(f"{label}: no replacement within 600 s")
            time.sleep(0.1)
        warm = victim.restart_ttft
        if warm is None or warm >= cold[vid]:
            fail(f"{label}: the replacement's restart_ttft {warm} s is not "
                 f"below the victim's first {cold[vid]} s")
        if not victim.cache_stats or victim.cache_stats["hits"] <= 0 \
                or victim.cache_stats["misses"] \
                or any(not c or c["misses"] <= 0
                       for c in cold_cache.values()):
            fail(f"{label}: the replacement's compile cache "
                 f"{victim.cache_stats} (want hits, no build), the first "
                 f"starts' {cold_cache} (want builds)")
        # a second wave under a cluster-wide profile capture, its
        # submissions spaced past a poll so the router sees each worker's
        # load rise, and routed by load alone (the survivor's cache holds
        # the shared prefix, whose affinity would draw the whole wave), so
        # both workers serve
        cluster.affinity_weight = 0.0
        # a process's first profiler window initialises CUPTI first, for
        # as long as a short wave takes to finish: a window of none in
        # every process before the wave, whose start latency is printed,
        # so the measured window opens while the wave decodes
        warm_up = cluster.capture_profile(0.0)
        warm_profs = (warm_up or {}).get("capture", {}).get("profiler", {})
        creqs2 = []
        for p in prompts:
            creqs2.append(cluster.submit(p, max_new_tokens=STACK_NEW2))
            time.sleep(0.12)
        bundle = cluster.capture_profile(1.0)
        pending2 = {rid: sum(c.replica_id == rid and not c.done
                             for c in creqs2) for rid in reps}
        outs2 = [c.result(timeout=600) for c in creqs2]
        routed2 = {rid: sum(c.replica_id == rid for c in creqs2)
                   for rid in reps}
        snap = cluster.scrape()
        mem_peak = worker_memory()
    except BaseException:
        # a failed check ends the run: no worker outlives it
        for rep in cluster.replicas().values():
            if rep._proc is not None and rep._proc.poll() is None:
                rep._proc.kill()
        cluster.stop()
        raise
    stop_workers(cluster)
    shutil.rmtree(tmp, ignore_errors=True)
    cap = bundle.get("capture", {}) if bundle else {}
    profs = cap.get("profiler", {})
    if sorted(cap.get("workers", [])) != ["replica-0", "replica-1",
                                          "router"] \
            or not all(p and p.get("ok") for p in profs.values()) \
            or any(profs[r].get("device_events", 0) <= 0
                   for r in ("replica-0", "replica-1")):
        fail(f"{label}: capture_profile workers {cap.get('workers')}, "
             f"profilers {profs} (the warm-up window's {warm_profs}), the "
             f"wave's requests by replica {routed2}, of them unfinished "
             f"when the capture returned {pending2}")
    if any(o is None or len(o) != STACK_NEW2 for o in outs2):
        fail(f"{label}: the second wave's statuses "
             f"{[c.status for c in creqs2]}")
    spans = device_spans_ms(bundle)
    compiles = metric_values(snap, "paddle_tpu_xla_compile_total")
    att_loads = {k[0]: v for k, v in compiles.items()
                 if len(k) > 1 and k[1] == "kernel:ragged_paged_attention"}
    gen = metric_values(snap, "serving_generated_tokens_total")
    peaks = metric_values(snap, "paddle_tpu_device_peak_bytes_in_use")
    if not {"replica-0", "replica-1"} <= set(att_loads) \
            or not {("replica-0",), ("replica-1",)} <= set(gen):
        fail(f"{label}: the merged scrape lacks a worker: kernel loads "
             f"{att_loads}, generated {gen}")
    floor = hold_floor(label, token_gaps(model, dev, prompts + prompts,
                                         outs + outs2))
    n_tok = NEW * len(prompts)
    print(f"{label}: {card_line()}; workers up in {t_up:.1f} s; "
          f"restart_ttft cold {cold} (compile cache {cold_cache}) warm "
          f"{vid} {warm:.2f} s (cache {victim.cache_stats}); wave 1 {n_tok} tokens "
          f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s with {vid} "
          f"SIGKILLed ({n_failed_over} requests failed over; requests by "
          f"replica {routed}, second wave {routed2}); kernel "
          f"library loads of ragged_paged_attention by replica {att_loads}; "
          f"generated tokens by replica {gen}; allocator peak bytes by "
          f"replica {peaks}; card MiB by process after start {mem_up}, "
          f"at the second wave {mem_peak}; profile shards "
          f"{ {w: p.get('device_events') for w, p in profs.items()} } "
          f"(device records over ms of the window {spans}; profiler start "
          f"ms, first window "
          f"{ {w: round(p.get('start_ms', -1), 1) for w, p in warm_profs.items()} }"
          f", measured "
          f"{ {w: round(p.get('start_ms', -1), 1) for w, p in profs.items()} }"
          f"; unfinished at its return {pending2}); "
          f"{floor}; phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)


# ----------------------------------------------------------------------
# phase 20: MoE training; phase 21: AMP debugging; phase 22: weight
# quantization, the rest
# ----------------------------------------------------------------------
# 20a: Llama-3-8B width with the recipe's --moe 8 (Mixtral-8x7B's expert
# shapes: 8 SwiGLU experts of 14336, top 2), cut to 2 layers: 3.95 G
# parameters, 63.2 GB of f32 weights, gradients and AdamW moments
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_LAYERS, MOE_BATCH, MOE_STEPS = 2, 1, 10
MOE_CORPUS_VOCAB = 8192     # ids of the 20a corpus: a marginal to learn
MOE_TINY_EXPERTS = 4        # 20b
MOE_LAYER_N = (2048, 1024)  # 20c: tokens of the first two calls, another
QUANT_FIT_STEPS = 40        # 22c


def counter_value(name, label):
    from paddle_tpu_torch.observability import metrics as om
    return om.counter(name, "", labelnames=("callable",)).labels(label).value


def replay_counts(step, counter):
    """What one replay of the compiled ``step`` adds to ``counter``."""
    import collections
    (_, counts, _), = step._graphs._graphs.values()
    out = collections.Counter()
    for c, d in counts:
        if c is counter:
            out.update(d)
    return dict(out)


@contextlib.contextmanager
def counted_moe_plain_versions():
    """Count the training path's plain versions and the grouped GEMM's."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    with counted_plain_versions() as calls, \
            count_calls([(GG, "grouped_gemm_ref")]) as gg_calls:
        yield calls, gg_calls


def moe_gemm_times(dev, layers, n, d, f, e):
    """The step's grouped products on their own, at its shapes (n tokens,
    top 2, E experts, the dropless E * n rows, each expert 2 n / E real
    rows), f32 as under O1, CUDA events: one #6 forward launch on x [E n,
    D] against w [E, D, F] with its bound and its plain version's time,
    and the weight gradients, three ``grouped_gemm_dw`` a layer (gate and
    up: x [E n, D], g [E n, F]; down: h [E n, F], g [E n, D]). Returns
    ``(dw ms a step, {name: ms})``."""
    import torch
    from paddle_tpu_torch.ops.grouped_gemm import (grouped_gemm,
                                                   grouped_gemm_dw,
                                                   grouped_gemm_ref)
    gen = torch.Generator(dev).manual_seed(5)
    gs = torch.full((e,), n * MOE_TOP_K // e, dtype=torch.int32, device=dev)
    a = torch.randn(e * n, d, device=dev, generator=gen)
    b = torch.randn(e * n, f, device=dev, generator=gen)
    w = torch.randn(e, d, f, device=dev, generator=gen)
    rows = n * MOE_TOP_K
    t = {"gg_tile": time_ms(lambda: grouped_gemm(a, w, gs), 5, 1),
         "gg_plain": time_ms(lambda: grouped_gemm_ref(a, w, gs), 3, 1),
         "gg_bound": roofline(4 * (rows * d + e * d * f + e * n * f),
                              2 * rows * d * f, F32_FLOPS)[0],
         "dw_up": time_ms(lambda: grouped_gemm_dw(a, b, gs, torch.float32),
                          3, 1),
         "dw_down": time_ms(lambda: grouped_gemm_dw(b, a, gs,
                                                    torch.float32), 3, 1)}
    del a, b, w
    torch.cuda.empty_cache()
    return layers * (2 * t["dw_up"] + t["dw_down"]), t


def moe_pretrain(dev):
    """Phase 20a: ``llama_pretrain.main --config 8b --layers 2 --moe 8
    --moe-top-k 2 --amp --batch 1 --seq 2048 --steps 10`` over a seeded
    corpus: one capture, each replay launching a layer's flash kernels
    once each and the grouped GEMM (#6) three times forward and three
    for dx, one loss kernel a step, no plain version, finite and falling
    losses. Returns the run's launches."""
    import tempfile
    import torch
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    from paddle_tpu_torch.ops import grouped_gemm as GG
    layers = MOE_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = compiles_of("llama_pretrain.step")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        path = corpus(tmp, MOE_CORPUS_VOCAB)
        args = ["--config", "8b", "--layers", str(layers), "--moe",
                str(MOE_EXPERTS), "--moe-top-k", str(MOE_TOP_K), "--amp",
                "--batch", str(MOE_BATCH), "--seq", str(TRAIN_S),
                "--steps", str(MOE_STEPS), "--data", path]
        with counted_moe_plain_versions() as (plain_calls, gg_plain):
            reset_launches()
            res = llama_pretrain.main(args)
            torch.cuda.synchronize()
            launches = dict(FT.launches, ce=FC.launches,
                            gg=GG.launches["grouped_gemm"])
            instances = {k: v for k, v in GG.instance_launches.items()
                         if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls or gg_plain:
        fail(f"20a: plain versions ran: {sorted(set(plain_calls + gg_plain))}")
    step = res["step"]
    captures = compiles_of("llama_pretrain.step") - before
    if len(step._cache) != 1 or captures != 1:
        fail(f"20a: {len(step._cache)} graphs, {captures} captures (want "
             "one of each)")
    per = dict(replay_counts(step, FT.launches),
               ce=sum(replay_counts(step, FC.instance_launches).values()),
               gg=replay_counts(step, GG.launches).get("grouped_gemm", 0))
    per_inst = {k: v for k, v in replay_counts(
        step, GG.instance_launches).items() if v}
    want = dict(forward=layers, dq=layers, dkv=layers, ce=1, gg=6 * layers)
    if per != want:
        fail(f"20a: launches per replay {per} != {want}")
    total = {k: v * (MOE_STEPS + 1) for k, v in want.items()}
    if launches != total:
        fail(f"20a: launches {launches} != {total} (the eager warm-up, the "
             "capture's real step and the replays)")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"20a: losses not finite and falling: {losses}")
    model = res["model"]
    cfg = model.config
    n_params = model.num_params()
    steady = res["step_s"][2:]
    step_s = sum(steady) / len(steady)
    tokens = MOE_BATCH * TRAIN_S
    del res, model, step
    gc.collect()
    torch.cuda.empty_cache()
    dw, t = moe_gemm_times(dev, layers, tokens, cfg.hidden_size,
                           cfg.moe_intermediate_size
                           or cfg.intermediate_size, MOE_EXPERTS)
    print(f"20a MoE recipe: layers={layers} experts={MOE_EXPERTS} "
          f"top_k={MOE_TOP_K} params={n_params} batch={MOE_BATCH} "
          f"seq={TRAIN_S} steps={MOE_STEPS} loss_first={losses[0]:.4f} "
          f"loss_last={losses[-1]:.4f} step_ms={step_s * 1e3:.1f} (graphed, "
          f"mean of steps 3-{MOE_STEPS}) tokens_per_s={tokens / step_s:.0f} "
          f"peak_mem_gb={peak:.2f} launches_per_replay={per} "
          f"grouped_gemm_instances_per_replay={per_inst} "
          f"grouped_gemm_instances_run={instances} captures={captures}",
          flush=True)
    print(f"20a weight gradients: grouped_gemm_dw gate/up {t['dw_up']:.2f} "
          f"ms, down {t['dw_down']:.2f} ms (f32 bmm over all "
          f"{MOE_EXPERTS * tokens} rows); {dw:.1f} ms a step = "
          f"{dw / (step_s * 1e3):.3f} of the step; one #6 forward at the "
          f"step's gate shape on the f32 tile instance {t['gg_tile']:.3f} "
          f"ms (bound {t['gg_bound']:.3f}, operations; plain "
          f"{t['gg_plain']:.3f})", flush=True)
    return launches


@contextlib.contextmanager
def plain_grouped():
    """Route the float grouped GEMM to its plain version on the card (the
    comparison runs only)."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    saved = GG._launch_float
    GG._launch_float = GG.grouped_gemm_ref
    try:
        yield
    finally:
        GG._launch_float = saved


def moe_compare_step(dev):
    """Phase 20b: one step (loss and every gradient, f32) of the tiny
    config with ``--moe 4`` through the kernels against the same step
    through the plain versions, on the same weights and batch: the loss
    within LOSS_REL, each gradient within GRAD_REL of its largest
    value."""
    import numpy as np
    import torch
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.ops import grouped_gemm as GG
    model = build_model("tiny", device=dev, seed=0, moe=MOE_TINY_EXPERTS,
                        moe_top_k=MOE_TOP_K)
    ids = np.random.RandomState(3).randint(
        0, model.config.vocab_size, (2, 129)).astype(np.int64)
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    params = dict(model.named_parameters())

    def step():
        loss, _ = model(x, y)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in params.items()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads
    reset_launches()
    loss_k, g_k = step()
    gg = GG.launches["grouped_gemm"]
    layers = model.config.num_hidden_layers
    if gg != 6 * layers:
        fail(f"20b: {gg} grouped GEMM launches, want {6 * layers}")
    with plain_paths(), plain_grouped():
        loss_p, g_p = step()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if not rel <= LOSS_REL:
        fail(f"20b: loss {loss_k} vs plain {loss_p}")
    worst = 0.0
    for n in params:
        a, b = g_k[n].float(), g_p[n].float()
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, err)
        if not err <= GRAD_REL:
            fail(f"20b: gradient of {n} {err:.2e} of its max from the plain "
                 "path's")
    print(f"20b MoE step (tiny, --moe {MOE_TINY_EXPERTS}, f32, kernels vs "
          f"plain): loss={loss_k:.6f} plain={loss_p:.6f} rel={rel:.2e} "
          f"worst_grad={worst:.2e} of max over {len(params)} tensors "
          f"grouped_gemm_launches={gg}", flush=True)


def moe_layer_phase(dev):
    """Phase 20c: ``MoELayer`` at Mixtral width (D 4096, H 14336, E 8,
    gshard) on 2048 tokens, forward and backward: ragged (#6, dx through
    it) against dense within GRAD_REL of each tensor's largest value,
    ``dropped`` equal, the ``moe_layer`` compile count 1 after two calls
    of one token count and 2 after another. Returns #6's launches."""
    import torch
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.ops import grouped_gemm as GG
    d, h, e = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"], 8
    n, other = MOE_LAYER_N
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(n, d, device=dev, generator=gen)
    cot = torch.randn(n, d, device=dev, generator=gen)

    def layer(mode):
        return MoELayer(d, h, e, gate="gshard", dispatch_mode=mode,
                        device=dev,
                        generator=torch.Generator(dev).manual_seed(0))

    def run(moe):
        xr = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = moe(xr)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {k: p.grad for k, p in moe.named_parameters()}
        grads["x"] = xr.grad
        return (out.detach(), float(moe.l_aux.detach()), int(moe.dropped),
                grads, ms)
    c0 = counter_value("paddle_tpu_xla_compile_total", "moe_layer")
    ragged = layer("ragged")
    reset_launches()
    r = run(ragged)
    ragged.zero_grad(set_to_none=True)
    r2 = run(ragged)
    gg = GG.launches["grouped_gemm"]
    inst = {k: v for k, v in GG.instance_launches.items() if v}
    c1 = counter_value("paddle_tpu_xla_compile_total", "moe_layer") - c0
    with torch.no_grad():
        ragged(x[:other])
    c2 = counter_value("paddle_tpu_xla_compile_total", "moe_layer") - c0
    if (c1, c2) != (1, 2):
        fail(f"20c: moe_layer compiles {c1} after two calls of n={n}, {c2} "
             f"after n={other} (want 1, 2)")
    if gg != 8:
        fail(f"20c: {gg} grouped GEMM launches over two forward and "
             "backward calls (want 8: two products and their dx each)")
    if not (torch.equal(r[0], r2[0]) and r[2] == r2[2]):
        fail("20c: two ragged calls on the same input differ")
    del ragged, r2
    torch.cuda.empty_cache()
    dense = layer("dense")
    dn = run(dense)
    del dense
    if r[2] != dn[2]:
        fail(f"20c: dropped {r[2]} (ragged) vs {dn[2]} (dense)")
    errs = {}
    for k, a, b in [("out", r[0], dn[0]), ("l_aux", torch.tensor(r[1]),
                                           torch.tensor(dn[1]))] \
            + [(k, r[3][k], dn[3][k]) for k in dn[3]]:
        errs[k] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
        if not errs[k] <= GRAD_REL:
            fail(f"20c: {k} ragged vs dense {errs[k]:.2e} of its max")
    print(f"20c MoELayer (D {d}, H {h}, E {e}, gshard, n={n}): ragged "
          f"fwd+bwd {r[4]:.1f} ms, dense {dn[4]:.1f} ms (host clock, "
          f"synchronised, first calls) dropped={r[2]} l_aux={r[1]:.6f} "
          f"worst_rel={max(errs.values()):.2e} ({max(errs, key=errs.get)}) "
          f"compiles={c1},{c2} grouped_gemm={inst}", flush=True)
    return gg


def moe_phase(dev):
    """Phase 20: 20a-20c; returns 20a's launches plus #6's of 20c."""
    import torch
    t0 = time.perf_counter()
    launches = moe_pretrain(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_compare_step(dev)
    torch.cuda.empty_cache()
    launches["gg"] += moe_layer_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# a node's declaration in CUDA's DOT dump of a graph
# (cudaGraphDebugDotPrint), its type, and a kernel's name after its ID
GRAPH_NODE = re.compile(r'^"graph_\d+_node_\d+"\s*\[', re.M)
GRAPH_NODE_TYPE = re.compile(
    r"\b(KERNEL|MEMCPY|MEMSET|HOST|EMPTY|WAIT_EVENT|EVENT_RECORD|MEM_ALLOC"
    r"|MEM_FREE|GRAPH|CONDITIONAL|BATCH_MEM_OP)\b")
GRAPH_KERNEL_NAME = re.compile(r"\{ID \| [^|}]*\| ([^\\|{}<\s]+)")


def captured_nodes(fn):
    """The work one call of ``fn`` puts on the card, counted exactly: the
    nodes of a CUDA graph captured from it (after one run on the capture
    stream), each as (type, the kernel's name or ""), sorted. A
    ``torch.profiler`` window can lose records (PERF.md §7); a capture
    records every launch. The launch counters are left as they were."""
    import tempfile
    import torch
    from paddle_tpu_torch.ops import _build, _graphs
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    try:
        # kept after the capture for the dump, where PyTorch has keep_graph
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()      # debug mode keeps it
    graph.enable_debug_mode()
    before = [dict(c) for c in _build.COUNTERS]
    try:
        with torch.cuda.graph(graph, stream=stream):
            fn()
    finally:
        _graphs._take_back(before)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    del graph
    gc.collect()
    torch.cuda.empty_cache()
    starts = [m.start() for m in GRAPH_NODE.finditer(text)] + [len(text)]
    nodes = []
    for a, b in zip(starts, starts[1:]):
        kind = GRAPH_NODE_TYPE.search(text, a, b)
        name = GRAPH_KERNEL_NAME.search(text, a, b)
        nodes.append((kind.group(1) if kind else "node",
                      name.group(1) if name else ""))
    if not nodes:
        fail(f"captured_nodes: no node in the graph's DOT dump "
             f"({len(text)} bytes: {text[:300]!r})")
    return sorted(nodes)


def node_kinds(nodes):
    import collections
    return dict(collections.Counter(kind for kind, _ in nodes))


def amp_debug_phase(dev):
    """Phase 21: AMP debugging at the 2-layer cut of phase 5's model: the
    op table of one O1 forward (the matmul family in bf16), the same
    forward's launches (:func:`captured_nodes`) with the collection off
    as before the seam was first installed, the checker's raise on an injected Inf, a captured
    step under the checker bitwise the unchecked one with no host read
    in it, ``check_numerics`` on the card."""
    import tempfile
    import torch
    from torch.utils._python_dispatch import (
        _disable_current_modes, _get_current_dispatch_mode_stack)
    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.framework import dispatch
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.observability import metrics as om
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    model, ids = training_model(dev, PRETRAIN_CUT)
    x = torch.from_numpy(ids[:1, :-1]).to(dev)
    y = torch.from_numpy(ids[:1, 1:]).to(dev)

    def forward():
        with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
            return model(x, y)[0]
    forward()
    if dispatch.installed() or _get_current_dispatch_mode_stack():
        fail("21: a dispatch mode is installed before any was asked for")
    nodes0 = captured_nodes(forward)
    debugging.enable_operator_stats_collection()
    forward()
    stats = debugging.disable_operator_stats_collection()
    mm = stats.get("mm", {})
    if not mm.get("bf16") or mm.get("fp32") or mm.get("fp16"):
        fail(f"21: the O1 forward's mm row is {mm}, want bf16 only")
    if _get_current_dispatch_mode_stack():
        fail("21: the seam stayed installed after the collection")
    nodes1 = captured_nodes(forward)
    if nodes1 != nodes0:
        fail(f"21: a forward puts {len(nodes1)} nodes {node_kinds(nodes1)} "
             f"on the card after the collection against {len(nodes0)} "
             f"{node_kinds(nodes0)} before")
    print(f"21 op stats (2 layers, O1 bf16 forward): {len(stats)} ops, mm "
          f"{mm}, sdpa {stats.get('scaled_dot_product_attention')}; the "
          f"forward's captured graph holds the same {len(nodes0)} nodes "
          f"{node_kinds(nodes0)} ({len(set(nodes0))} distinct) before and "
          "after", flush=True)

    def inject(mod, args):
        with _disable_current_modes():
            h = args[0].clone()
            h[0, 7, 11] = float("inf")
        return (h,) + tuple(args[1:])
    hook = model.model.layers[1].register_forward_pre_hook(inject)
    debugging.enable_tensor_checker()
    try:
        forward()
    except FloatingPointError as e:
        raised = str(e)
    else:
        fail("21: an Inf in layer 1's input raised nothing under the "
             "tensor checker")
    finally:
        debugging.disable_tensor_checker()
        hook.remove()
    if "'rms_norm'" not in raised:
        fail(f"21: the checker's raise names another op: {raised}")
    print(f"21 tensor checker: {raised}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    reads = []
    check = dispatch.check_outputs

    def counted_check(name, outs):
        # a read: a floating output checked outside a compiled step
        if not dispatch._skip_check() and any(
                isinstance(o, torch.Tensor) and o.is_floating_point()
                for o in outs):
            reads.append(name)
        return check(name, outs)

    def steps(checked):
        m, _ = training_model(dev, PRETRAIN_CUT)
        opt = AdamW(learning_rate=3e-4, weight_decay=0.1,
                    parameters=m.named_parameters())

        def step_fn(a, b):
            with amp.auto_cast(dtype="bfloat16"):
                loss, _ = m(a, b)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = jit.to_static(step_fn, state=[m, opt], warmup="once",
                             name="chip_smoke.checked_step")
        small = torch.from_numpy(ids[:1, :129]).to(dev)
        wx, wy = small[:, :-1], small[:, 1:]
        bx, by = x[:, :512], y[:, :512]
        if checked:
            debugging.enable_tensor_checker()
        try:
            step(wx, wy)
            n_warm = len(reads)
            losses = [step(bx, by) for _ in range(3)]
            torch.cuda.synchronize()
        finally:
            debugging.disable_tensor_checker()
        losses = [float(v) for v in losses]
        digest = recipe_digest(m, opt)
        del m, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return losses, digest, n_warm
    dispatch.check_outputs = counted_check
    try:
        checked = steps(True)
    finally:
        dispatch.check_outputs = check
    compiled_reads = len(reads) - checked[2]
    plain = steps(False)
    if checked[:2] != plain[:2]:
        fail(f"21: the compiled step under the checker {checked[0]} is not "
             f"bitwise the unchecked one {plain[0]}")
    if not checked[2] or compiled_reads:
        fail(f"21: the checker read {checked[2]} outputs in the eager "
             f"warm-up and {compiled_reads} in the compiled steps (want "
             "some, then none)")
    print(f"21 checker over a compiled step: eager warm-up {checked[2]} "
          f"outputs read, the capture call and 2 replays 0; losses "
          f"{checked[0]} bitwise the unchecked run's, every parameter and "
          "moment too", flush=True)

    t = torch.arange(64, dtype=torch.float32, device=dev)
    t[[1, 5, 9]] = float("nan")
    t[[2, 7]] = float("inf")
    fam = om.counter("paddle_tpu_nan_inf_detected_total", "",
                     labelnames=("op", "var"))
    c0 = fam.labels("chip_smoke", "t").value
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fr_") as tmp:
        fr.install(log_dir=tmp)
        try:
            got = debugging.check_numerics(t, "chip_smoke", "t")
        finally:
            fr.uninstall()
        dumps = [p for p in os.listdir(tmp)
                 if os.path.isdir(os.path.join(tmp, p))]
    if got != (3, 2) or fam.labels("chip_smoke", "t").value != c0 + 1 \
            or len(dumps) != 1:
        fail(f"21: check_numerics gave {got}, the counter "
             f"{fam.labels('chip_smoke', 't').value - c0}, {len(dumps)} "
             "flight-recorder dumps (want (3, 2), 1, 1)")
    print(f"21 check_numerics: {got} on the card, counter +1, one "
          "flight-recorder dump", flush=True)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def quant_ckpt_phase(dev):
    """Phase 22a: phase 9's cut (Llama-3-8B width, 4 layers, bf16) served
    with int8 weights, ``save_quantized``, ``load_quantized`` into a model
    built afresh and served again on phase 4's prompts: every token
    bitwise the first engine's, #8 and #12 launches counted. Returns
    ``(#12 launches, #8 launches)``."""
    import shutil
    import tempfile
    import torch
    from paddle_tpu_torch.quant import (load_quantized, save_quantized,
                                        serving_weight_bytes)
    layers = LADDER_LAYERS
    cfg, model = llama_model(dev, layers)
    prompts = serving_prompts(cfg.vocab_size)
    bf16_bytes = serving_weight_bytes(model)[0]

    def served(m, label):
        engine = serving_engine(m, weight_dtype="int8")
        with tick_taps(engine) as taps, finite_taps(m, taps):
            warm_up(engine, prompts)
            run = served_run(engine, prompts, label, "fused_rope", layers,
                             taps)
        del engine
        torch.cuda.empty_cache()
        return run
    a = served(model, "22a before save")
    root = tempfile.mkdtemp(prefix="chip_smoke_qckpt_")
    try:
        host_room(root, bf16_bytes)
        t0 = time.perf_counter()
        step_dir = save_quantized(model, root)
        save_s = time.perf_counter() - t0
        ckpt = dir_bytes(step_dir)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        _, fresh = llama_model(dev, layers)
        t0 = time.perf_counter()
        if load_quantized(fresh, root) != 0:
            fail("22a: load_quantized found no committed step")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    b = served(fresh, "22a after load")
    del fresh
    if a[1] != b[1]:
        n_eq = sum(p == q for o, ob in zip(a[1], b[1]) for p, q in zip(o, ob))
        fail(f"22a: {n_eq} of {len(prompts) * NEW} tokens equal after "
             "load_quantized (want all)")
    dq = sum(a[7].values())
    if dq != sum(b[7].values()) or not dq:
        fail(f"22a: dequant matmul launches {a[7]} then {b[7]}")
    print(f"22a quantized checkpoint (llama3_8b width, {layers} layers): "
          f"{ckpt} bytes against {bf16_bytes} in bf16 "
          f"({ckpt / bf16_bytes:.3f}), save_s={save_s:.2f} "
          f"load_s={load_s:.2f}; tokens bitwise over "
          f"{len(prompts) * NEW}; dequant launches {a[7]} a run; "
          f"tokens_per_s={len(prompts) * NEW / a[2]:.1f} before, "
          f"{len(prompts) * NEW / b[2]:.1f} after", flush=True)
    return a[3] + b[3], dq + sum(b[7].values())


def qat_bridge_phase(dev):
    """Phase 22b: QAT, ``convert`` and ``bridge_model`` on a stack of
    ``torch.nn.Linear`` 4096 -> 14336 -> 4096 on the card: the bridged
    weights dequantize bitwise to the ``ConvertedLinear``'s, and the
    forward through #8 is within #8's bound of the plain forward.
    Returns #8's launches."""
    import torch
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.quant import bridge_model, dequantize_weight
    from paddle_tpu_torch.quant import kernels as QK
    d, f = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"]
    gen = torch.Generator(dev).manual_seed(2)
    stack = torch.nn.Sequential(torch.nn.Linear(d, f, device=dev),
                                torch.nn.Linear(f, d, device=dev))
    with torch.no_grad():
        for p in stack.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(64, d, device=dev, generator=gen)
    qat = Q.QAT(Q.QuantConfig()).quantize(stack)
    qat(x).pow(2).mean().backward()
    if not all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in qat.parameters()):
        fail("22b: the QAT stack's straight-through gradients are missing "
             "or not finite")
    conv = Q.QAT(Q.QuantConfig()).convert(qat)
    with torch.no_grad():
        src = [c.weight_int8.float() * (c.weight_scale / 127.0)
               for c in conv]
        plain = conv(x)
    if bridge_model(conv) != 2:
        fail("22b: bridge_model swapped another count than 2 layers")
    for i, m in enumerate(conv):
        deq = dequantize_weight(m.weight_int8, m.weight_scale,
                                m.weight_block)
        if not torch.equal(deq, src[i]):
            fail(f"22b: layer {i}'s bridged weight is not bitwise the "
                 "ConvertedLinear's")
    with count_calls([(QK, "dequant_matmul_ref")]) as plain_calls, \
            torch.no_grad():
        reset_launches()
        got = conv(x)
        torch.cuda.synchronize()
        inst = {k: v for k, v in QK.instance_launches.items() if v}
    if plain_calls or sum(inst.values()) != 2:
        fail(f"22b: dequant launches {inst}, plain calls {plain_calls}")
    err = check_close("22b bridged stack vs ConvertedLinear", got, plain)
    print(f"22b QAT -> convert -> bridge ({d} -> {f} -> {d}, f32 x of 64 "
          f"rows): bridged weights bitwise, out max_abs_err={err:.3e} "
          f"(#8's bound), dequant instances {inst}", flush=True)
    return 2


def quality_phase(dev):
    """Phase 22c: ``fit_on_prompts`` (40 steps) and ``logits_quality`` of
    the tiny config, float against int8, on the card: ``passes``."""
    import copy
    import torch
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    from paddle_tpu_torch.quant import kernels as QK
    from paddle_tpu_torch.quant import quality, quantize_model
    model = build_model("tiny", device=dev, seed=0)
    loss = quality.fit_on_prompts(model, steps=QUANT_FIT_STEPS)
    model.eval()
    q = quantize_model(copy.deepcopy(model))
    with count_calls([(QK, "dequant_matmul_ref")]) as plain_calls:
        reset_launches()
        report = quality.logits_quality(model, q)
        dq = QK.launches
    if plain_calls or not dq:
        fail(f"22c: dequant launches {dq}, plain calls {plain_calls}")
    print(f"22c quality gate (tiny, fit {QUANT_FIT_STEPS} steps to loss "
          f"{loss:.4f}): {report}", flush=True)
    if not report["passes"]:
        fail(f"22c: the int8 model fails the quality gate: {report}")
    return dq


def quant_phase(dev):
    """Phase 22: 22a-22c; returns (#12 launches, #8 launches)."""
    import torch
    t0 = time.perf_counter()
    rpa_launches, dq = quant_ckpt_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    dq += qat_bridge_phase(dev)
    torch.cuda.empty_cache()
    dq += quality_phase(dev)
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t0:.1f} s", flush=True)
    return rpa_launches, dq


# ----------------------------------------------------------------------
# phase 23: distributed, part 1, in a NCCL world of one rank: the
# collectives (23a), the recipe's --mesh 1x1 (23b: phase 5's model cut to
# 2 layers, 3 steps) and --mesh 1x1 --moe 8 --ep (23c: 1 layer, 2 steps)
DIST_LAYERS, DIST_STEPS = 2, 3
DIST_MOE_LAYERS, DIST_MOE_STEPS = 1, 2
DIST_LOSS_REL = 1e-4      # a mesh's losses against one device's, relative
DIST_TIMEOUT_S = 120      # the world's rendezvous and collectives
DIST_CHILD_S = 300        # the phase's process, killed past it
DIST_CHILD_FLAG = "--dist-phase"


@contextlib.contextmanager
def nccl_world_of_one(dev):
    """A NCCL world of one rank over a ``FileStore`` in a temp dir,
    destroyed on the way out, also when the body fails."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import set_mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        yield
    finally:
        set_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def dist_collectives(dev):
    """Phase 23a: the collective API, p2p and the layers' regions on card
    tensors in the world of one; an NCCL all-reduce in a CUDA graph."""
    import numpy as np
    import torch
    import paddle_tpu_torch.distributed as pd
    from paddle_tpu_torch.distributed import p2p
    from paddle_tpu_torch.distributed.plan import ParallelPlan
    mesh = pd.ProcessMesh(np.array([[0]]), ["dp", "mp"])
    pd.set_mesh(mesh)
    x = torch.arange(1, 9, dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(x)
    bad = []

    def hold(name, got, want):
        if not (got.device == x.device and torch.equal(got, want)):
            bad.append(name)
    for op in ("sum", "max", "min", "prod", "avg"):
        hold(f"all_reduce {op}", pd.all_reduce(x.clone(), op=op,
                                               group="mp"), x)
    lst = []
    hold("all_gather", pd.all_gather(lst, x, group="mp"), x)
    hold("all_gather list", torch.stack(lst), x[None])
    objs = []
    pd.all_gather_object(objs, "rank0", group="mp")
    if objs != ["rank0"]:
        bad.append("all_gather_object")
    out = torch.empty_like(x)
    hold("reduce_scatter", pd.reduce_scatter(out, x.clone(), group="mp"), x)
    res = []
    hold("alltoall", pd.alltoall(res, [x], group="mp"), x[None])
    hold("broadcast", pd.broadcast(x.clone(), src=0, group="mp"), x)
    hold("reduce", pd.reduce(x.clone(), dst=0, group="dp"), x)
    hold("scatter", pd.scatter(torch.empty_like(x), [x], src=0,
                               group="mp"), x)
    pd.barrier(group="mp")
    pd.barrier()
    hold("wait", pd.wait(x), x)
    hold("shift", p2p.shift(x, "mp", offset=1, wrap=True), x)
    hold("send_forward", p2p.send_forward(x, "mp"), zeros)
    hold("send_backward", p2p.send_backward(x, "mp"), zeros)
    hold("ppermute", p2p.ppermute(x, "mp", [(0, 0)]), x)
    if (p2p.axis_rank("mp"), p2p.axis_size("mp"), pd.get_rank(),
            pd.get_world_size()) != (0, 1, 0, 1):
        bad.append("axis queries")
    try:
        pd.send(x)
        bad.append("send did not raise")
    except NotImplementedError:
        pass
    # the layers' collectives run NCCL on a group of one as on any other
    plan = ParallelPlan(mesh, tp="mp")
    x2 = x.reshape(2, 4)
    hold("copy_to", plan.copy_to(x2, "mp"), x2)
    hold("reduce_from", plan.reduce_from(x2, "mp"), x2)
    hold("gather_from", plan.gather_from(x2, "mp", -1), x2)
    hold("gather_sum", plan.gather_sum(x2, "mp", 0), x2)
    hold("reduce_scatter region", plan.reduce_scatter(x2, "mp", 1), x2)
    hold("mean_over_batch", plan.mean_over_batch(x2), x2)
    if bad:
        fail(f"23a: wrong on the card in a world of one: {bad}")
    # the layers' all-reduce captured into a CUDA graph and replayed on
    # new data (NCCL enqueues no kernel for a communicator of one rank:
    # the nodes show what the capture holds)
    buf = x.clone()
    nodes = captured_nodes(lambda: plan.reduce_from(buf, "mp"))
    graph, stream, held = torch.cuda.CUDAGraph(), torch.cuda.Stream(), {}
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        plan.reduce_from(buf, "mp")
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        held["y"] = plan.reduce_from(buf, "mp")
    buf.mul_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(held["y"], buf):
        fail("23a: a replay of the captured all-reduce gave "
             f"{held['y'].tolist()} for {buf.tolist()}")
    del graph
    print(f"23a collectives in a NCCL world of one: all_reduce x5 ops, "
          f"all_gather(_object), reduce_scatter, alltoall, broadcast, "
          f"reduce, scatter, barrier, wait, shift, send_forward, "
          f"send_backward, ppermute, axis queries, the six layer regions "
          f"on card tensors right; send raises; the layers' all-reduce "
          f"captured into a CUDA graph and replayed right, its nodes "
          f"{nodes} (NCCL kernels among them: "
          f"{sorted({n for _, n in nodes if 'nccl' in n.lower()})})",
          flush=True)


def dist_launches():
    """The launches of #1-#3, #5 and #6 so far."""
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    from paddle_tpu_torch.ops import grouped_gemm as GG
    return dict(FT.launches, ce=FC.launches,
                gg=GG.launches["grouped_gemm"])


def mesh_run(label, base, mesh_flags, want_per, layers):
    """The recipe at ``base`` on one device, then with ``mesh_flags``
    (in the world of one): the mesh run counted (plain versions, launches,
    captures), its losses held against the one-device run's. Returns its
    launches."""
    import torch
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import grouped_gemm as GG
    torch.cuda.reset_peak_memory_stats()
    single = llama_pretrain.main(base)
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    single_losses = single["losses"]
    single_ms = 1e3 * sum(single["step_s"][1:]) / len(single["step_s"][1:])
    del single
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = compiles_of("llama_pretrain.step")
    with counted_moe_plain_versions() as (plain_calls, gg_plain):
        reset_launches()
        res = llama_pretrain.main(base + mesh_flags)
        torch.cuda.synchronize()
        launches = dist_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls or gg_plain:
        fail(f"{label}: plain versions ran: "
             f"{sorted(set(plain_calls + gg_plain))}")
    model, step = res["model"], res["step"]
    if model.plan is None:
        fail(f"{label}: the model was not placed over the mesh")
    captures = compiles_of("llama_pretrain.step") - before
    if len(step._cache) != 1 or captures != 1:
        fail(f"{label}: {len(step._cache)} graphs, {captures} captures "
             "(want one of each: the step and its collectives captured)")
    per = dict(replay_launches(step),
               gg=replay_counts(step, GG.launches).get("grouped_gemm", 0))
    if per != want_per:
        fail(f"{label}: launches per replay {per} != {want_per}")
    steps = len(res["losses"])
    total = {k: v * (steps + 1) for k, v in want_per.items()}
    if launches != total:
        fail(f"{label}: launches {launches} != {total}")
    losses = res["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, single_losses))
    if not all(math.isfinite(v) for v in losses) or rel > DIST_LOSS_REL:
        fail(f"{label}: mesh losses {losses} against one device's "
             f"{single_losses} (max rel {rel:.2e} > {DIST_LOSS_REL})")
    mesh_ms = 1e3 * sum(res["step_s"][1:]) / len(res["step_s"][1:])
    print(f"{label} recipe {' '.join(mesh_flags)}: layers={layers} "
          f"steps={steps} losses_mesh={[f'{v:.6f}' for v in losses]} "
          f"losses_single={[f'{v:.6f}' for v in single_losses]} "
          f"max_rel={rel:.2e} step_ms={mesh_ms:.1f} (graphed, steps "
          f"2-{steps}; one device {single_ms:.1f}) peak_mem_gb={peak:.2f} "
          f"(one device {single_peak:.2f}) "
          f"launches_per_replay={per} captures={captures} (the step's "
          f"NCCL collectives inside its graph)", flush=True)
    return launches


def dist_phase():
    """Phase 23 in a child process (``python3 chip_smoke.py
    --dist-phase OUT``), which runs :func:`dist_phase_child` and writes
    its launches to ``OUT``: NCCL's state, and its destruction, stay out
    of this process, whose phase 17 opens a profiler window. The child is
    killed past ``DIST_CHILD_S``. Returns the launches of #1-#3 and #5
    (``forward``, ``dq``, ``dkv``, ``ce``) and of #6 (``gg``) of the mesh
    runs."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        out = os.path.join(tmp, "launches.json")
        try:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  DIST_CHILD_FLAG, out],
                                 timeout=DIST_CHILD_S)
        except subprocess.TimeoutExpired:
            fail(f"phase 23: its process ran past {DIST_CHILD_S} s and was "
                 "killed")
        if res.returncode != 0 or not os.path.exists(out):
            fail(f"phase 23: its process exited with {res.returncode}")
        with open(out) as f:
            launches = json.load(f)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s (its process "
          "included)", flush=True)
    return launches


def dist_phase_child(out):
    """The child of :func:`dist_phase`: :func:`dist_runs` on the card,
    its launches written to ``out`` as JSON."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    launches = dist_runs(torch.device("cuda"))
    with open(out, "w") as f:
        json.dump(launches, f)


def dist_runs(dev):
    """23a-23c in one NCCL world of one rank; returns their launches."""
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        path = corpus(tmp, 128256)
        with nccl_world_of_one(dev):
            dist_collectives(dev)
            gc.collect()
            torch.cuda.empty_cache()
            base = recipe_args(path, DIST_LAYERS, DIST_STEPS)
            dense = mesh_run("23b", base, ["--mesh", "1x1"],
                             dict(forward=DIST_LAYERS, dq=DIST_LAYERS,
                                  dkv=DIST_LAYERS, ce=1, gg=0),
                             DIST_LAYERS)
            gc.collect()
            torch.cuda.empty_cache()
            base = ["--config", "8b", "--layers", str(DIST_MOE_LAYERS),
                    "--moe", str(MOE_EXPERTS), "--moe-top-k",
                    str(MOE_TOP_K), "--amp", "--batch", str(MOE_BATCH),
                    "--seq", str(TRAIN_S), "--steps", str(DIST_MOE_STEPS),
                    "--data", path]
            moe = mesh_run("23c", base, ["--mesh", "1x1", "--ep"],
                           dict(forward=DIST_MOE_LAYERS, dq=DIST_MOE_LAYERS,
                                dkv=DIST_MOE_LAYERS, ce=1,
                                gg=6 * DIST_MOE_LAYERS), DIST_MOE_LAYERS)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"23 in its process: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {k: dense[k] + moe[k] for k in dense}


def check_capture_failure(dev):
    """A step that reads the device on the host cannot be captured: the
    capture helper raises what the capture raised (no phase catches it
    around a real step, so such a failure ends the run), leaves the
    current stream as it was, and a good step still captures and replays
    after it."""
    import torch
    from paddle_tpu_torch.ops._graphs import StepGraphs
    steps = StepGraphs(dev)
    x = steps.buffer("x", (8,), torch.float32)
    stream = torch.cuda.current_stream(dev)
    try:
        steps.capture("host read", lambda: x.add_(float(x.sum().item())))
    except RuntimeError as e:
        err = str(e).strip().splitlines()[0]
    else:
        fail("a capture whose step reads the device on the host did not "
             "raise")
    if torch.cuda.current_stream(dev) != stream or "host read" in steps:
        fail("a failed capture left its stream current or its graph kept")
    x.fill_(1.0)
    steps.capture("good", lambda: x.mul_(2.0))
    steps.replay("good")
    torch.cuda.synchronize()
    if not torch.equal(x, torch.full_like(x, 4.0)):
        fail(f"a capture after a failed one replayed wrong: {x.tolist()}")
    print(f"capture failure: a host read under capture raised ({err}); the "
          "next capture and replay are right", flush=True)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not beside chip_smoke.py ({e})")
    dev = torch.device("cuda")
    # the engines' shape registry (compile_watch) in a directory of the
    # run's own, removed at the end
    import shutil
    import tempfile
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["PADDLE_TPU_COMPILE_CACHE_DIR"] = cache_dir
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # past the contract's 1200 s, every thread's stack goes to stderr
    faulthandler.dump_traceback_later(SMOKE_STACKS_S)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s={time.perf_counter() - t0:.1f}", flush=True)
    for line in flash_registers():
        print(line, flush=True)
    entry, = check_kernels(dev)                     # phase 3: #12
    family = check_kernels(dev, FAMILY)             # phase 3d
    domain_errs = check_kernel_domain(dev)          # phase 3d, widened
    long_errs = check_long_context(dev)             # phase 3f
    for e in [entry] + family:
        key = next(k for k, v in VARIANTS.items() if v[0] == e["name"])
        e["max_abs_err"] = max(e["max_abs_err"], domain_errs[key],
                               long_errs.get(key, 0.0))
    paged = check_paged_kernel(dev)                 # phase 3e: #4
    torch.cuda.empty_cache()
    training_entries = check_flash(dev) + [check_ce(dev)]
    torch.cuda.empty_cache()
    moe_entries = check_moe_kernels(dev)
    gemm_errs = check_gemm_domain(dev)               # phase 3c, C6
    for e in moe_entries:
        e["max_abs_err"] = max(e["max_abs_err"], gemm_errs[e["name"]])
    torch.cuda.empty_cache()
    sampler = check_sampler(dev)                    # phase 3g
    torch.cuda.empty_cache()
    bf16 = serve(dev, tick_check=True)              # phases 4, 4b
    entry["launches"] = bf16["launches"]
    torch.cuda.empty_cache()
    sampler["launches"] = serve_sampled(dev, bf16)  # phase 11
    torch.cuda.empty_cache()
    sampler["launches"] += generate_phase(dev)      # phase 12
    torch.cuda.empty_cache()
    kv8_launches = serve(dev, "int8", bf16, tick_check=True)["launches"]  # 8
    torch.cuda.empty_cache()
    ladder = serve_ladder(dev)                      # phase 9
    torch.cuda.empty_cache()
    entry["launches"] += serve_domain(dev)          # phase 9b
    torch.cuda.empty_cache()
    paged["launches"] = decode_cache(dev)           # phase 10
    torch.cuda.empty_cache()
    _, model = llama_model(dev, PREFIX_LAYERS)      # phases 13-15b
    entry["launches"] += serve_prefix(dev, model)   # phase 13 (+ the COW)
    kv8_launches += serve_prefix(dev, model, "int8")   # phase 13b
    torch.cuda.empty_cache()
    pressure_launches, pressure = serve_pressure(dev, model)   # phase 14a
    entry["launches"] += pressure_launches
    torch.cuda.empty_cache()
    entry["launches"] += serve_pause(dev, model, pressure)    # phase 14c
    torch.cuda.empty_cache()
    entry["launches"] += serve_lifecycle(dev, model)   # phase 14b
    torch.cuda.empty_cache()
    entry["launches"] += serve_spec(dev, model)     # phase 15
    torch.cuda.empty_cache()
    spec_launches, spec_gumbel = serve_spec_sampled(dev, model)  # 15b
    entry["launches"] += spec_launches
    sampler["launches"] += spec_gumbel
    torch.cuda.empty_cache()
    entry["launches"] += serve_observed(dev, model)  # phase 16
    del model
    torch.cuda.empty_cache()
    paths = serve_prefix_paths(dev)                 # phase 13c
    pause_paths = serve_pause_paths(dev)            # phase 14d
    spec_paths = serve_spec_paths(dev)              # phase 15c
    entry["launches"] += paths["fused_rope"] + spec_paths["fused_rope"] \
        + pause_paths["fused_rope"]
    for e, key in zip(family, FAMILY):
        e["launches"] = kv8_launches if key == "fused_rope_q8" \
            else ladder[key]
        e["launches"] += paths[key] + spec_paths[key] + pause_paths[key]
    torch.cuda.empty_cache()
    launches, eager_step_s = train(dev)
    torch.cuda.empty_cache()
    compare_step(dev)
    torch.cuda.empty_cache()
    compare_step(dev, use_amp=False)
    torch.cuda.empty_cache()
    int8_launches = serve_mixtral_int8(dev)
    torch.cuda.empty_cache()
    float_launches = serve_mixtral_bf16(dev)
    for e, counts in zip(moe_entries, (float_launches, int8_launches,
                                       int8_launches)):
        e["launches"] = counts[e["name"]]
    # phase 18 runs after 5b, and after the phases whose profiler windows
    # are held exactly (6, 7): in a run with phase 18 before them, a
    # window of phase 6 lost a tick's records
    torch.cuda.empty_cache()
    print(f"phases before 18: {time.perf_counter() - t0:.1f} s", flush=True)
    recipe, o1_step_s = pretrain_phase(dev, eager_step_s)      # phase 18
    torch.cuda.empty_cache()
    fit = fit_phase(dev, o1_step_s)                 # phase 19
    torch.cuda.empty_cache()
    moe_train = moe_phase(dev)                      # phase 20
    torch.cuda.empty_cache()
    amp_debug_phase(dev)                            # phase 21
    torch.cuda.empty_cache()
    quant_rpa, quant_dq = quant_phase(dev)          # phase 22
    entry["launches"] += quant_rpa
    torch.cuda.empty_cache()
    dist = dist_phase()                             # phase 23
    for e, key in zip(training_entries, ("forward", "dq", "dkv", "ce")):
        e["launches"] = launches[key] + recipe[key] + fit[key] \
            + moe_train[key] + dist[key]
    # phase 17 runs after every phase that counts profiler records: its
    # /debug/profile window opens on a server thread
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    _, model = llama_model(dev, PREFIX_LAYERS)      # phase 13's model again
    entry["launches"] += serve_stack(dev, model)    # phase 17a
    torch.cuda.empty_cache()
    serve_stack_workers(dev, model)                 # phase 17b
    del model
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)
    moe_entries[0]["launches"] += moe_train["gg"] + dist["gg"]
    moe_entries[2]["launches"] += quant_dq
    check_capture_failure(dev)
    shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"smoke_s={time.perf_counter() - t0:.1f} (build and every phase)",
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    # again at the end: a reader of the output's tail finds the card there
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [entry] + family + [paged]
                      + training_entries + moe_entries + [sampler]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == DIST_CHILD_FLAG:
        dist_phase_child(sys.argv[2])
    else:
        main()
