"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from this checkout (all ``nvcc``
   processes at once) and print the build seconds;
3. hold each kernel against its plain PyTorch twin at the paths' widths
   (bf16 outputs within 1e-2 * (1 + |plain|), lse and loss within 1e-3):
   flash prefill on the tensor-core body (head_dim 64, 128, 256, causal
   and not, GQA, S != T, the train shape); decode at a tick's widths on
   the tick body (R = Tq * G < R_TC, bf16, int8 and fp32 caches, the same
   bits on a second call), and at prefill-chunk widths (Tq * G from R_TC -
   1 to 1024 query rows per kv head, the tensor-core route from R_TC on),
   head_dim 64, 128 and 256, bf16 and int8; block-table (paged) decode on
   each of its routes (the tick body below R_TC, the tensor-core body
   reading the pool in place from R_TC on), bf16 and int8, whose free
   slots must come back exactly zero and whose live slots must equal the
   contiguous kernel on a gathered copy bit for bit, the same bits again
   on a second call; the flash backward (dq, dk/dv) at
   the train shape, head_dim 64/128/256, causal and not, ragged T, S != T,
   GQA, on the tensor-core bodies at head_dim 64/128 (``route_bwd``);
   the fused softmax-CE forward and backward at the train loss head and
   at ragged shapes; the fused LayerNorm forward and backward at the train
   shapes (F = 2048 and the 760M rungs' 1536) and at ragged shapes up to
   F = 8192 and N = 4099 (both bit-equal on a second call);
   the W4A16 matmul at N = 1, 8, 64, 128, 256 for each gpt_1p3b weight
   shape, bf16 on the tensor-core body and fp32 on the FMA body (counted
   by ``tc_launches``), nibble extremes included;
4. check the decode paths on the card against the CPU on small fp32
   models (fp32 and int8 KV): contiguous prefill and batched decode, then
   paged prefill chunks and paged decode steps through shuffled block
   tables; then the same contiguous checks on int8 and int4 weight-only
   models with ``PADDLE_TPU_W4_KERNEL=1``; then small fp32 models served
   through the step Engine's CUDA graphs against eager steps (contiguous,
   paged through shuffled tables, int8 KV, int4 with the W4 kernel):
   graphed tick, ``tick_block(8)`` and async streams equal to the eager
   tick's exactly, captured logits within PATH_TOL of the eager step's;
   budgeted (``prefill_budget=16``) graphed, block and async streams held
   to the eager monolithic ones (a PATH_TOL tie at most), each admission
   kind's graph bit-equal to its eager body from one cache state (and
   after its feeds change: another slot, offset and length), and a
   prompt re-admitted after a drained server's ``warmup()`` bit-equal to
   the same walk without it; then the device feed's counts
   (``feed_small_vs_cpu``): on MHA over an fp32 cache, GQA over an int8
   one and an int4 tree on the W4 kernel, both layouts, every step a
   graphed card serve builds counts the FLOPs and bytes the same step
   counts in a CPU serve; then five AdamW train steps of
   small fp32 models (MHA with learned positions, GQA with rope; accum 1
   and 2; the LayerNorm ones again with ``PADDLE_TPU_FUSED_LN=1``) on the
   card against the same steps on the CPU; then the rest of the training
   surface on a small fp32 rope model with the fused LN and CE kernels,
   accum 2, five steps each on the card against the CPU: AdamW under no
   remat, full remat and "dots" (each remat run bit-equal to no remat on
   the card), dropout 0.1 with a fixed key without remat and under
   "dots" (bit-equal again), Adafactor, Lamb, AdamW with a
   ``ClipGradByGlobalNorm`` and on a ``LinearWarmup`` schedule; then MoE
   training on a small fp32 model (4 top-2 experts, router noise 0.1,
   every step under a key; ``moe_train_small_vs_cpu``): five AdamW steps
   without remat, under full remat and under "dots" (each bit-equal to no
   remat on the card) and one step at cf 0.5 (assignments dropped), each
   against the same run on the CPU;
5. time each kernel with CUDA events at its path's shapes (L2 flushed
   and the host's enqueue hidden before each launch), beside its plain twin, its least possible time on
   the card, and a PyTorch call on the same work as a yardstick the port
   never calls (``scaled_dot_product_attention`` and its backward,
   ``cross_entropy`` and its backward, ``layer_norm`` and its backward,
   a bf16 ``matmul`` on a pre-dequantized weight; for the paged kernel
   SDPA on a pre-gathered contiguous copy, the gather timed on its own);
   the decode kernel also at admission widths R = 128 and 256, and the
   paged kernel at the paged serve's admission widths C = 128 and 256,
   both at a speculative verify's (B = 8, K = 4 rows a slot, T = 512),
   and on the contiguous kernel's own memory viewed as blocks (the
   tables' cost; bit-equal outputs);
   the W4 kernel at N = 8, 64, 128 and 256 for each gpt_1p3b
   weight shape; the LayerNorm backward's row pass and column sum apart;
6. the main path, as ``paddle_tpu_torch.tools.profile_serving.
   build_main_path`` defines it: GPT-1.3B (``gpt.gpt_1p3b()``, full width,
   random weights from a seed, bf16) served by ``DecodeServer(max_batch=8,
   max_len=512)`` — 8 greedy requests, prompts of 40..300 tokens (prefill
   buckets 64, 128, 256, 512), 64 new tokens each — warmed up
   (``DecodeServer.warmup``), then served through the step Engine: every
   tick one replay of the captured step graph and every admission one
   replay of its bucket's graph, with the device feed printed one line a
   step the server built (``serving.step``'s FLOPs equal to
   ``step_flops`` of the config at 8 slots and a 512-row window, its MFU
   known and below 1, its HBM use at most HBM_UTIL_CAP of the peak rate —
   the W4 path too), with the kernels'
   launch counts read around it (every flash forward on the tensor-core
   body, every decode launch on the tick body: ``tick_launches``; a
   replay counts the launches it captured) and one
   request checked against a solo ``generate``; then the same requests
   served three more ways, a fresh server each on the same weights —
   eager ticks (the private ``_graphs=False``), graphed
   ``tick_block(8)``, graphed ``async_dispatch=True`` ticks — with
   tokens/s, tick ms, admission ms, peak memory, warmup seconds and
   graphs for each of the four, every graphed way's streams held to the
   eager ones by the tie rule; then one admission profiled eager and
   graphed (``profile_serving.profile_admission``: wall, device ms,
   launches) — the same for phases 7 and 8;
7. the paged path, as ``build_paged_path`` defines it: the same model
   behind ``DecodeServer(layout="paged", block_size=16, num_blocks=128)``,
   8 chat requests sharing a 200-token system prompt — served tokens equal
   to a contiguous server's on the same prompts and one request to a solo
   ``generate``; the allocator's prefix hits, copies-on-write and radix
   splits; the kernels' launch counts read around it, each admission's
   width C and the tensor-core paged launches it added (each chunk one
   replay of its width's graph): every launch of
   the path is the block-table kernel's (none of the contiguous one), each
   tick on its tick body, each admission at C >= R_TC on its tensor-core
   body reading the pool in place (the tick body below);
8. the W4 path, as ``build_w4_path`` defines it: the main path's model and
   requests with int4 weights (group 64) and ``PADDLE_TPU_W4_KERNEL=1`` —
   every tick a replay of the step graph and every admission of its
   bucket's, exactly 6 W4 launches per layer
   in every decode tick and in every
   admission at a prefill bucket of at most 256 rows (none at 512), each
   on the tensor-core body (``tc_launches``), every decode launch on the
   tick body, two
   requests checked against a solo ``generate`` on the dequantizing route
   (flag off), weight bytes against the bf16 model's; between phases 7
   and 8, the budgeted serve: the main path's requests arriving over time
   (4 at once, then one every 8 ticks) on two graphed servers,
   monolithic and ``prefill_budget=64`` — streams equal by the tie rule,
   each long prompt claimed, chunks interleaved, each chunk one replay;
   the monolithic serve's longest stall against the budgeted serve's
   longest tick while a slot admits; then greedy ``generate.generate``
   on GPT-1.3B (8 prompts of 64 tokens, 32 new): one replay of its
   captured step a position, rows equal by the tie rule to a server's;
   then the speculation phase (``spec_phase``, K = 4): on small fp32
   models the batched verify's logits on the card against the CPU's
   (PATH_TOL) and a speculating card server's greedy streams exactly the
   plain CPU server's, both layouts; on GPT-1.3B the main path's 8
   requests, graphed and warmed, plain and with draft == target (a second
   cache, the same weights) on the contiguous and the paged layout —
   gated: streams equal to plain by the tie rule, every served token
   within TIE_TOL of the best logit of a teacher-forced forward over its
   own stream, target passes a token
   at least 1.5x fewer, every verify one replay of ``spec_verify@4`` with
   no capture or build after warmup, one tick-body launch of the decode
   kernel a layer a verify and every decode launch on the tick body —
   and the same gates for tree speculation (draft == target, N = 4 nodes,
   branch 2), whose every round is one replay of ``spec_tree_verify@4``
   with no decode launch in it (its attention is the einsum under the
   tree mask); on the small fp32 models the tree verify's logits card
   against CPU (PATH_TOL) and the tree servers' streams (draft == target
   and the biased draft) exactly the plain CPU server's — then, reported:
   the JAX bench's small drafter (hidden 512, 4 layers, 8 heads, seed 1),
   the bench's biased draft (the final LN bias plus 30 x wte[42]) tree
   against linear, n-gram self-drafting linear and tree on prompts whose
   second half repeats the first, and sampled serves at temperature 1,
   draft == target linear and tree, beside a plain sampled serve (each
   arm's tokens/s, target passes a token, acceptance, fallbacks, draft
   steps, the mean accepted path, the device ms of a replay of each
   graph a round runs);
   then the beam phase (``beam_phase``): small fp32 models' beam search
   on the card equal to the CPU's (tokens exactly, scores within 1e-4);
   GPT-1.3B, 2 prompts of 64 tokens, 32 new: one beam equals greedy
   ``generate`` by the tie rule, width 4 replays its ``beam`` graph once a
   position, with the call's wall, the beam graph's, the prompt step's
   and the cache reorder's device ms;
   then the pressure phase on GPT-1.3B (``pressure_phase``): the paged
   path's server under ``profile_serving.pressure_waves`` (six waves of 8
   chat requests with system prompts A, B, C, D, E, then A again) three
   times — with the host-RAM spill tier, evict-only, and a roomy pool of
   512 blocks that never relieves — with the spill's and the restore's
   wall a block and the returning wave's admissions profiled (device ms
   by family); gates: blocks spilled, the returning wave's chain restored
   (one ``inject`` replay a restored run) and none of its 192 shared rows
   recomputed, streams equal to the roomy serve's by the tie rule, every
   launch on the block-table kernel's tick and tensor-core bodies; then,
   on the main path's model and prompts: an async graphed server whose
   injected OOMs walk the ladder (async -> sync, cap 4, 2, 1, evicting
   with progress carried), a budgeted server whose half-prefilled slot
   is evicted and admitted again, the wedge watchdog (``wedged`` set by
   the hung fetch, cleared by the next tick), a real
   ``torch.cuda.OutOfMemoryError`` classified and survived, a TTL shed
   and a NaN-poisoned tick — streams held to the unfaulted serves' by
   the tie rule — and the OOM drill again on small fp32 models (PATH_TOL);
   then the overload phase (``overload_phase``), admission control on
   the main path's model at ``prefill_budget=64`` (ladder widths 64, 32,
   16), every server warmed up first: the 8 requests served unloaded (the
   reference streams, the decode gap's p50, tokens/s); the ladder arm —
   ``profile_serving.overload_waves`` (48 requests, classes 0/1/2, 4
   every 0.24 s) against a decode-gap objective of half that p50 over
   0.2 s windows, scraped at 10 Hz by a ``/metrics`` client — gated: rung
   4 reached, claimed widths walking 64 -> 32 -> 16 (each claim at the
   controller's width, each chunk one replay of its width's graph), only
   class-0 submits at rung 4 rejected (``result`` raises
   ``Overloaded``), no capture and no recompile record after warmup,
   every chunk on #9's tensor-core body and every tick on its tick body,
   admitted streams equal to the unloaded ones by the tie rule, one span
   of each kind per finished request, every scrape valid Prometheus text
   with the rung seen rising, and the rung back at 0 at the first idle
   window; two tenants flooding at half the unloaded tokens/s each
   (admitted tokens within 20%, throttles counted); a burst of 24 under
   a queue cap of 4 (the newest past the cap rejected, class 2 admitted
   first); ``/healthz`` 200 -> 503 -> 200 through the wedge drill, a
   Chrome trace of two requests' spans and ``torch.profiler`` kernels
   (``chiprun_out/overload_trace.json``), a card memory sample; and the
   cost of telemetry: main's requests with it off, on, and on under a
   10 Hz scrape (streams equal); after the W4 path, the trees the other
   phases bypass (``trees_phase``): GPT-1.3B with int8 KV and with GQA
   16/4 on the main and paged paths, each served eagerly and then
   graphed — the graphed streams held to the eager ones by the tie rule,
   every token within TIE_TOL of its teacher-forced best, every tick on
   the tick body, every admission on its tensor-core body (a GQA chunk
   past 1024 query rows a kv head in pieces), ``serving.step``'s FLOPs
   ``step_flops``' — the int4 tree on the paged path (144 W4 launches a
   tick and a chunk of at most 256 rows, all on the tensor-core body),
   and the OOM ladder, wedge, TTL and NaN drills on the int4 tree and on
   a draft == target K = 4 speculating server; the seconds the feed
   checks, the trees' phase and the sampled tree serve took, and the
   whole smoke's; then the MoE phase (``moe_phase``): (a) a small fp32
   MoE model (4 top-2 experts, C = 3 at 4 slots) card against CPU —
   joint-routing step logits within PATH_TOL and its routing counters
   equal, six requests served by tick, ``tick_block(8)``, async and
   budgeted admission on both layouts, graphed and eager, each equal to
   the CPU's serve in streams, drops and expert load, and the zero-router
   model at cf 0.5 whose device drop counter must equal the host-replayed
   schedule; (b) ``gpt_1p3b()``'s widths with 8 top-2 experts in fp32
   (~28 GB of weights, TF32 off) at the dropless cf 4.0: 4 of main's
   requests for 32 tokens, graphed, main and paged — the streams exactly
   ``moe_serving.dense_reference_greedy``'s with no drop counted; (c) the
   same model in bf16 at cf 1.25 serving main's 8 requests on both
   layouts, eager then graphed and warmed — tokens/s, tick ms, admission
   ms, reserved memory, weight bytes, ``moe_dropped_tokens``, the drop
   rate and ``moe_expert_load``; gated: every tick one replay of
   ``serving.moe_step`` with no capture after warmup, every decode launch
   on #9 / #10's tick body, every admission's flash forward on #1's
   tensor-core body (paged: #10's bodies by width), the feed's FLOPs
   ``moe_step_flops`` (C = 3) with MFU and HBM use in range, the graphed
   streams held to the eager ones by ``moe_hold`` (a tie in the
   teacher-forced routed context of the eager streams); reported: the
   share of served tokens within TIE_TOL of the teacher-forced dense-eval
   best and a dense-eval arm's decode tokens/s beside the routed serve's
   (the JAX bench's ``vs_dense_eval``); then the fleet phase
   (``fleet_phase``, ``text/fleet.py``): (a) small fp32 models, the card
   against the CPU — loopback fleets of 2 graphed replicas and 1 worker
   (its own CUDA stream) on both layouts at ``PADDLE_TPU_STREAM_CHUNK_ROWS``
   0 and 8, fp32 and int8 KV, a socket fleet over 127.0.0.1 with the
   worker served in process by ``serve_prefill_worker``, a live add and
   remove of a replica, the autoscale drill and a spilled chain migrated
   between paged replicas: every card stream the single card server's
   exactly and the CPU run's (a PATH_TOL tie at most); (b) GPT-1.3B (bf16,
   random weights from seed 0) on the JAX bench's mixed schedule (6
   64-token prompts at iteration 0, 1536-token ones at 8 and 24, 64 new
   tokens each, ``max_len`` 1600): one server (``max_batch`` 8), a
   loopback fleet of 2 replicas (``max_batch`` 4) and 1 worker streaming
   256-row chunks, the same fleet answering whole, and the fleet on the
   short prompts alone, all graphed after warmup — the decode-loop gap p50
   and p99 (``bench_fleet``'s: the wall of a drive iteration that started
   with work mid-decode), tokens/s, handoffs, stream chunks and bytes,
   the worker's ms a handoff and reserved memory; the mixed-over-short
   gap p99 ratio beside the bench's 4.0 (reported, not gated: the worker
   shares the card's SMs); gated: the fleet's streams the single server's
   by the tie rule, both long prompts handed off, no capture and no build
   after warmup, every decode launch on #9's tick body, every worker
   prefill's flash on #1's tensor-core body and every ``prefill_chunk@W``
   launch on #9's tensor-core body, counted after the threads joined;
   (c) 2 paged replicas (``block_size`` 16) and a paged worker on the
   paged path's chat prompts: streams the single paged server's by the
   tie rule, every #10 launch on its body (decode steps on the tick body,
   admission and worker chunks on the tensor-core body); (d) the wedge
   drill on a 1.3B fleet of 2 async one-slot replicas (the JAX bench's
   ``wedge:tick:1``): ``fleet.reroutes`` > 0, ``healthz`` flipping and
   recovering, streams the unfaulted single async server's by the tie
   rule;
9. the train rungs, as ``paddle_tpu_torch.tools.profile_train.
   build_train_path`` defines them (``RUNGS``, the JAX bench's recipes):
   GPT-1.3B with fp32 master weights from a seed, batch 8 x 2048 tokens in
   8 micro-batches, AdamW (bf16 moments), the fused loss head
   (``PADDLE_TPU_FUSED_CE=1``); the headline rung (the fused LayerNorm
   too); GPT-760M, batch 16 in 16, AdamW, fused LN and CE, without remat
   and under remat "dots"; GPT-1.3B under full remat with Adafactor;
   GPT-1.3B's widths with 8 top-2 experts a layer at 8 layers (router
   noise 0.01, each step under a key), AdamW, fused LN and CE, without
   remat and under full remat —
   four steps of each on one batch with step time, tokens/s, MFU (the
   JAX package's count, and for MoE the routed count
   ``moe_train_flops_per_token`` as ``mfu_routed``; for MoE too the drop
   rate of micro-batch 0's routing after the steps), peak
   memory (and its split at the optimizer update), the bytes one
   micro-batch's forward keeps, and each step's kernel launches, exactly
   as ``expected_train_launches`` counts them (every flash forward, dq and
   dk/dv on its tensor-core body, the recompute's included); the loss must
   start near ln(vocab) and fall, and a remat rung's forward must keep
   fewer bytes than its remat-off twin's, its step peak no more (the
   allocated peak; on the MoE twins the requested one);
9b. after the rungs, the data and comm phase (``data_comm_phase``): (a)
   the headline rung's batch written into four 16.8 MB token shards
   (``write_token_shards``: the batch four times at the head of the
   first, seeded filler after) and four steps of the headline rung from
   the same init fed by ``QueueDataset`` -> ``TokenShardReader(
   num_threads=1)`` -> ``DevicePrefetcher(depth=2)`` (pinned ring, side
   stream, events): every delivered batch the in-memory batch bit for
   bit, the losses the in-memory run's, #1-#7 launched exactly as its
   steps launch them; step ms against the in-memory run's, the prefetch
   queue's depth before each step, and the reader alone over the 64 MB
   at 1 and 4 threads (records/s; in order at 1, the multiset at 4); (b)
   the headline's fp32 gradients of one batch and two ``dgc_compress``
   calls on them (sparsity 0.99, momentum 0.9), each timed by CUDA events
   with its peak memory, every leaf of both rounds held to the DGC law
   (``_dgc_leaf_gate``: the kept set by ``kthvalue``, density within 1 -
   sparsity but for ties, send + v' = v + (m·u + g), u' and v' zero on
   the kept set and m·u + g, v + (m·u + g) off it), and a small model's
   rounds card vs CPU bit for bit; (c) rides in the hybrid phase's
   spawns: the functional pipeline (``build_pipeline_train_step``) on
   the small fp32 model at pp4 and dp2 x pp2 against the one-card step,
   DGC over dp4 and LocalSGD (k = 4, 8 steps) against one card, exact
   all-reduce counts, and GPT-1.3B's widths at dp2 x pp2, M = 2 on the
   headline batch's first 4 rows (one card: 4 layers) within
   HYBRID_1P3B_LOSS_TOL of one card's loss; each rank's #1-#7 launches
   exact.  ``python3 chip_smoke.py --data-comm-only`` runs the build, the
   headline rung in memory, (a), (b) and (c) in a spawn of its own;
10. after the LoRA phase, hybrid-parallel training (``hybrid_phase``,
   ``paddle_tpu_torch/distributed/`` and ``build_gpt_train_step(mesh=)``):
   four ranks spawned from this process (``distributed.spawn``; the
   kernels built here, so the ranks only load them), one a card over
   NCCL with four cards, else all on card 0 over gloo with collectives
   staged through pinned host memory (the phase's first line says
   which); first #1-#3 over a rank's 8 heads and #6 / #7 on a 25152-wide
   vocab shard (the backward fed the global lse) against their plain
   twins; (a) HYBRID_SMALL_STEPS AdamW steps of the small fp32 models
   (the base of the train checks above and its GQA-rope-RMSNorm-SwiGLU
   variant) at dp2 x
   mp2, pp2 x mp2 under 1F1B and F-then-B at 2 and 4 micro-batches, dp4
   at ZeRO 0-3 and dp2 x mp2 with a clipping global norm, fused CE and
   LN, against the one-card step on the same masters and batches
   (TRAIN_LOSS_TOL, TRAIN_PARAM_TOL but a TRAIN_PARAM_FAR share), each
   rank's launches of #1-#7 exact (``hybrid_check.
   expected_hybrid_launches``), and the vocab-parallel CE's kernel route
   against its plain twin on mp 4; (b) GPT-1.3B at pp2 x mp2, 1F1B, 8
   micro-batches on the headline rung's masters, batch and optimizer:
   step 1's loss within HYBRID_1P3B_LOSS_TOL of the headline rung's step
   1, step 2's below it, launches exact, step 3 profiled; each rank's
   step ms, peak memory, collective bytes and the collectives' share of
   its device time; (c) with four cards also dp2 x mp2 under ZeRO 1 at
   accum 4; (d) the sp and ep axes on the small fp32 models (sp2 x mp2
   contiguous and zigzag, with and without ``sp_sub_block``, pp2 x sp2
   under both schedules, sp4 zigzag, GQA on the ring, an MoE model at
   dp2 x ep2, ep2 x mp2, pp2 x ep2 and dp2 x sp2) under the same gates,
   the ring's launches exact (``ring_attention.launches``); (e) the
   ring's kernel route against its plain twin at GPT-1.3B's attention
   (T = 2048, hd 128, 16 heads over sp4 and 8 over sp2, both layouts,
   bf16, output and gradients; launches exact, all on tensor cores); (f)
   GPT-1.3B at sp2 x mp2 in both layouts and the MoE rung's model under
   ep (ep4 on one card, dp2 x ep2 on four; four cards add sp4 zigzag),
   each step-1 loss within HYBRID_1P3B_LOSS_TOL of the one-card loss on
   the same rows (``one_card_loss``) and falling at step 2.  On one card
   the dense arms of (b) and (f) run HYBRID_DENSE_LAYERS (8) deep, each
   against one card's loss at that depth, two steps, none profiled; the
   small runs take HYBRID_SMALL_STEPS (3; five on four cards).  One
   spawn of the ranks runs the whole phase, (c) of the data and comm
   phase and the PS phase's (d) with it.  ``python3
   chip_smoke.py --hybrid-only`` runs the build and this phase alone
   (``--full-width-only`` with it: (b), (c) and (f) only);
11. after it, tensor- and expert-parallel serving (``tp_phase``): a pool
   of four rank processes (four cards: NCCL, a card a rank, graphs; one
   card: gloo through pinned host buffers, eager) and, each against a
   single-card server, (a) + (e) the small fp32 models at mp2 with
   speculation and an adapter pool (streams equal), (b) GPT-1.3B at mp2
   and mp4, main and paged, (c) int4 ``build_sharded_decode`` at mp2 (both
   by the tie rule), (d) the 8-expert MoE model at ep2 x mp2 by the routed
   tie rule, and its fp32 twin held at every token and counter
   (``tp_moe_exact``); per-rank launches exact, one replay a tick a rank
   on four cards.  ``python3 chip_smoke.py --tp-only`` runs the build and
   this phase alone;
12. then the parameter-server services (``ps_phase``), which launch no
   kernel of the port (the counts, zeroed before, stay 0): (a) a 4096 x 16
   device table under 20 adagrad pushes with duplicates and
   tests/test_heter.py's V = 64 ``HeterTrainer``, card against CPU; (b)
   two host table servers holding the Criteo Kaggle table (33,762,577 x
   16, DLRM's slots; ``tools/criteo_dlrm.py``) and a ``HeterTrainer``
   running DLRM's Kaggle step on the card, 200 ``train_step`` and 200
   ``train_stream`` steps of 128 (the loss falls; touched rows move,
   untouched ones keep their bits); (c) ``TheOnePS`` holding the same
   table on the card: pull and push ms of 128 x 26 and 2048 x 26 ids,
   sampled rows against a float64 replay of the adagrad; (d) the table
   row-sharded over 4 ranks (NCCL a card a rank on four cards, else gloo
   ranks sharing card 0, staged) at 1/16 of the rows, its gathered rows
   the one-card table's after the same pushes — in the whole smoke its
   ranks' work runs in the hybrid phase's first spawn (no start-up of its
   own), held here.  ``python3 chip_smoke.py --ps-only`` runs this phase
   alone, (d)'s ranks (the same ``hybrid_check`` case) in a spawn of
   their own;
13. one ``{"kernels": [...]}`` JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero and prints no result without a CUDA card.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# bf16 outputs: |kernel - plain| <= TOL * (1 + |plain|) elementwise — one
# bf16 ulp (2^-7 relative) where fp32 summation order tips a rounding
BF16_TOL = 1e-2
LSE_TOL = 1e-3                   # fp32 lse, summation order only
PATH_TOL = 1e-3                  # fp32 logits, card vs CPU, TF32 off
# greedy streams of a random-weight bf16 model: bf16 logits of magnitude
# 2-8 step by 1/64-1/32, and the top two are often one step apart or equal,
# so two correct kernel routes may break a tie differently.  A stream that
# leaves the reference must do so on a token whose logit, in the
# reference's own context, is within two steps of the best one.
TIE_TOL = 0.0625
SPEC_K = 4                       # tokens a slot a speculative verify round
# CE dlogits are softmax values ~ 1/V, rounded once to bf16 by kernel and
# twin alike: |kernel - plain| <= CE_DX_ATOL + BF16_TOL * |plain|
CE_DX_ATOL = 1e-6
# small fp32 models trained on the card vs the CPU: fp32 losses differ by
# summation order only (TRAIN_LOSS_TOL).  Parameters: Adam divides by
# sqrt(v) + eps, so an element whose grad is ~eps or cancels to ~eps takes
# steps of up to lr whose size (or sign) rests on the last bits of that
# grad — and with accum 2 a grad on a bf16 rounding boundary of the carry
# rounds the other way on one side.  So a few elements may part by up to
# a step per step taken (TRAIN_STEPS * lr); all but a TRAIN_PARAM_FAR
# share of them must agree within TRAIN_PARAM_TOL.
# LayerNorm: mu and rstd are fp32 row statistics, dg and db fp32 sums over
# all N rows; kernel and twin sum in other orders (per CTA and warp, in row
# blocks): |kernel - plain| <= LN_FP32_TOL * (1 + |plain|)
LN_FP32_TOL = 1e-4
# fp32 W4 outputs: sums of up to 8192 products in another order
W4_FP32_TOL = 1e-4
# fp32 decode attention outputs: sums over the cache in another order
ATTN_FP32_TOL = 1e-4
TRAIN_LR = 1e-3
TRAIN_STEPS = 5
TRAIN_LOSS_TOL = 1e-4
TRAIN_PARAM_TOL = TRAIN_LR / 10
TRAIN_PARAM_FAR = 1e-4


def log(msg):
    print(msg, flush=True)


# cycles the card spins (about 1 ms) between the flush and a timed call, so
# the host has enqueued the whole call before its first event fires
SPIN_CYCLES = 2_000_000


def cold_ms(torch, fn, iters=20):
    """Median device time of ``fn`` over ``iters`` launches, each bracketed
    by CUDA events, with the 50 MB L2 flushed (a 256 MB write) before
    each: the real caller finds its inputs cold, 23 layers of weights
    having streamed through since.  The card then spins for SPIN_CYCLES,
    so host work inside ``fn`` (a wrapper's checks, autograd's backward
    setup) is never timed as device time, however slow the host."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def kernel_ms(torch, fn, names, iters=20):
    """Mean device ms of each kernel a call of ``fn`` launches, by name:
    ``names`` maps a label to a substring of the kernel's name.  The
    ``iters`` calls run as in :func:`cold_ms` (L2 flushed, card spinning)
    under ``torch.profiler``; raises if a label matched no kernel."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        for label, sub in names.items():
            if sub in evt.key and evt.self_device_time_total > 0:
                out[label] = out.get(label, 0.0) + \
                    evt.self_device_time_total / 1e3 / iters
    missing = set(names) - set(out)
    if missing:
        raise RuntimeError(f"kernel_ms: no device time for {sorted(missing)}")
    return out


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_flash(torch, fa):
    """bf16 flash forwards (the tensor-core body: ``route`` says so and
    ``tc_launches`` counts each) against the plain twin: every prefill
    bucket of the main path, a ragged T, the train shape, GQA, not causal,
    S != T, head_dim 64 and 256."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst_out = worst_lse = 0.0
    # (T, S, Hkv, D, causal), H = 16
    cases = [(T, T, 16, 128, True) for T in (64, 128, 256, 512, 1000)] + [
        (2048, 2048, 16, 128, True), (2048, 2048, 4, 128, False),
        (200, 333, 4, 128, False), (333, 200, 16, 64, True),
        (256, 256, 16, 64, True), (300, 300, 4, 256, True),
        (200, 200, 16, 256, False)]
    for T, S, Hkv, D, causal in cases:
        q = torch.randn(1, T, 16, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(1, S, Hkv, D, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        before = fa.flash_attention_fwd.tc_launches
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref, ref_lse = fa._plain_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        tc = fa.flash_attention_fwd.tc_launches - before
        e_out = (out.float() - ref.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=BF16_TOL,
                            rtol=BF16_TOL)
        log(f"  flash_fwd bf16 T={T} S={S} H=16 Hkv={Hkv} D={D} "
            f"causal={causal} ({fa.route(q.dtype, D)}, {tc} tc launch): "
            f"max|out-plain| {e_out:.3g} (tol {BF16_TOL}*(1+|plain|)), "
            f"max|lse-plain| {e_lse:.3g} (tol {LSE_TOL})")
        if not (ok and e_lse <= LSE_TOL and tc == 1):
            raise AssertionError(f"flash_fwd disagrees at T={T} S={S} "
                                 f"Hkv={Hkv} D={D} causal={causal}")
        worst_out, worst_lse = max(worst_out, e_out), max(worst_lse, e_lse)
    return worst_out


def check_decode(torch, da):
    """Decode at a tick's widths and a few more against the plain twin,
    each launch on the route ``da.route`` names (``tick_launches`` and
    ``tc_launches`` count them): the main path's shape (T = 512 cache
    rows, Hkv = 16, Tq = 1, bf16) first, then its speculative verify's
    (Tq = SPEC_K: R = 4 on the tick body), then T = 2048 over GQA, Tq = 4
    and int8, head_dim 256 (Tq = 16 at G = 4: the tensor-core route), the
    tick body's R = 12 and 15 at head_dim 64, 128 and 256, and fp32 q over
    an fp32 cache (tolerance 1e-4: summation order only).  A tick launch
    gives the same bits on a second call (its splits merge in order)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    B = 8
    worst = 0.0
    cases = [(512, 16, 1, "bf16", 128), (512, 16, SPEC_K, "bf16", 128)] + [
        (2048, h, tq, kv, 128) for h in (16, 4) for tq in (1, 4)
        for kv in ("bf16", "int8")] + [(1024, 4, 1, "bf16", 256),
                                       (1024, 4, 16, "int8", 256),
                                       (520, 4, 3, "int8", 64),
                                       (520, 16, 15, "bf16", 128),
                                       (520, 16, 15, "int8", 256),
                                       (520, 16, 1, "fp32", 128),
                                       (520, 4, 3, "fp32", 256)]
    for T, Hkv, Tq, kv, hd in cases:
        qdt = torch.float32 if kv == "fp32" else torch.bfloat16
        q = torch.randn(B, Tq, 16, hd, generator=gen, device="cuda").to(qdt)
        k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
        v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
        ks = vs = None
        if kv == "int8":
            k, ks = da.quantize_kv(k)
            v, vs = da.quantize_kv(v)
        elif kv == "bf16":
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        # frontiers in the first tile, on a tile edge, mid-cache, at the end
        pos = torch.tensor([0, 1, 63, 64, T // 3, T // 2, 3 * T // 4, T - Tq],
                           dtype=torch.int32, device="cuda")
        R = Tq * 16 // Hkv
        route = da.route(R, qdt, hd, k.dtype)
        before = (da.decode_attention.tick_launches,
                  da.decode_attention.tc_launches)
        out = da.decode_attention(q, k, v, pos, ks, vs)
        ref = da._plain_decode(q, k, v, pos, ks, vs, None)
        torch.cuda.synchronize()
        ran = (da.decode_attention.tick_launches - before[0],
               da.decode_attention.tc_launches - before[1])
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_TOL if qdt == torch.bfloat16 else ATTN_FP32_TOL
        log(f"  decode Hq=16 Hkv={Hkv} hd={hd} T={T} Tq={Tq} {kv} "
            f"({route}): max|out-plain| {err:.3g} (tol {tol}*(1+|plain|))")
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            raise AssertionError(f"decode disagrees at T={T} Hkv={Hkv} "
                                 f"Tq={Tq} {kv} hd={hd}")
        if ran != (route == "tick", route == "tc"):
            raise AssertionError(f"decode at R={R} {kv} ran (tick, tc) "
                                 f"{ran}, route {route}")
        if route == "tick" and not torch.equal(
                da.decode_attention(q, k, v, pos, ks, vs), out):
            raise AssertionError(f"the tick body gave other bits on a "
                                 f"second call at R={R} {kv} hd={hd}")
        worst = max(worst, err)
    return worst


def check_decode_wide(torch, da):
    """Prefill-chunk widths against the plain twin, each launch on the
    route ``da.route`` names (``tc_launches`` counts the tensor-core
    ones): R = Tq * G = 512 (G = 1) and 1024 (G = 4), bf16 and int8;
    ``R_TC`` - 1 and ``R_TC``; the paged serve's widths 128 and 256 past a
    200-row prefix; pos > 0 with a ragged T; G = 4 int8 at head_dim 64;
    head_dim 256."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    # (B, Tq, Hkv, T, pos0, kv, hd), Hq = 16
    for B, Tq, Hkv, T, pos0, kv, hd in [
            (2, 512, 16, 512, 0, "bf16", 128), (2, 512, 16, 512, 0, "int8", 128),
            (2, 256, 4, 512, 0, "bf16", 128), (2, 256, 4, 512, 0, "int8", 128),
            (1, da.R_TC - 1, 16, 512, 300, "bf16", 128),
            (1, da.R_TC, 16, 512, 300, "bf16", 128),
            (1, 128, 16, 512, 200, "bf16", 128),
            (1, 256, 16, 512, 200, "bf16", 128),
            (2, 96, 16, 333, 37, "bf16", 64), (2, 40, 4, 333, 150, "int8", 64),
            (2, 100, 4, 520, 300, "bf16", 256)]:
        q = torch.randn(B, Tq, 16, hd, generator=gen,
                        device="cuda").to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
        v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
        ks = vs = None
        if kv == "int8":
            k, ks = da.quantize_kv(k)
            v, vs = da.quantize_kv(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        pos = torch.tensor([pos0, T - Tq][:B], dtype=torch.int32,
                           device="cuda")
        R = Tq * 16 // Hkv
        route = da.route(R, q.dtype, hd, k.dtype)
        before = da.decode_attention.tc_launches
        out = da.decode_attention(q, k, v, pos, ks, vs)
        ref = da._plain_decode(q, k, v, pos, ks, vs, None)
        torch.cuda.synchronize()
        tc = da.decode_attention.tc_launches - before
        err = (out.float() - ref.float()).abs().max().item()
        log(f"  decode R={R} (Tq={Tq} G={16 // Hkv}) B={B} T={T} pos={pos0} "
            f"hd={hd} {kv} ({route}): max|out-plain| {err:.3g} "
            f"(tol {BF16_TOL}*(1+|plain|))")
        if not torch.allclose(out.float(), ref.float(), atol=BF16_TOL,
                              rtol=BF16_TOL) or tc != (route == "tc"):
            raise AssertionError(f"decode disagrees at R={R} {kv} hd={hd}")
        worst = max(worst, err)
    return worst


def paged_inputs(torch, da, gen, Tq, Hq, Hkv, bs, nmax, kv, pos_list,
                 hd=128):
    """q and a pool of B * nmax + 1 shuffled blocks: slot b maps distinct
    random blocks through its frontier pos + Tq - 1 and leaves the rest
    -1; a slot whose position is None is free (all -1, pos 0)."""
    B = len(pos_list)
    N = B * nmax + 1
    q = torch.randn(B, Tq, Hq, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn(N, bs, Hkv, hd, generator=gen, device="cuda")
    v = torch.randn(N, bs, Hkv, hd, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        k, ks = da.quantize_kv(k)
        v, vs = da.quantize_kv(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda").int()
    tables = torch.full((B, nmax), -1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos_list):
        if p is not None:
            used = (p + Tq - 1) // bs + 1
            tables[b, :used] = perm[b * nmax:b * nmax + used]
            pos[b] = p
    return q, k, v, ks, vs, tables, pos


def check_paged(torch, da):
    """The paged kernel against gather-then-attend on every live slot, at
    the paged path's tick shape first (B = 8, Hq = Hkv = 16, bs = 16,
    nmax = 32, bf16) and its speculative verify's (Tq = SPEC_K: R = 4 on
    the tick body over the tables), then GQA, Tq = 4, int8, block size 8,
    the routes'
    edge R_TC - 1 / R_TC and the paged serve's admission widths 128 and
    256 (bf16 and int8); last, head_dim 256.  Each launch on the route
    ``da.paged_route`` names (``tick_launches`` and ``tc_launches`` count
    them); a free slot must return exactly zero (the kernel reads no
    unmapped block); live slots must equal the contiguous kernel on
    ``gather_paged_view``'s copy bit for bit (the same body walks the
    same rows in the same order under the same plan), and a second call
    the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    fn = da.paged_decode_attention
    for Tq, Hkv, kv, bs, hd in [(1, 16, "bf16", 16, 128),
                                (1, 16, "int8", 16, 128),
                                (SPEC_K, 16, "bf16", 16, 128),
                                (4, 4, "bf16", 8, 128),
                                (4, 4, "int8", 16, 128),
                                (da.R_TC - 1, 16, "bf16", 16, 128),
                                (da.R_TC - 1, 16, "int8", 8, 128),
                                (da.R_TC, 16, "bf16", 16, 128),
                                (da.R_TC, 16, "int8", 8, 128),
                                (64, 4, "bf16", 16, 128),
                                (128, 16, "bf16", 16, 128),
                                (128, 16, "int8", 16, 128),
                                (256, 16, "bf16", 16, 128),
                                (256, 16, "int8", 64, 128),
                                (4, 4, "bf16", 16, 256),
                                (64, 4, "int8", 16, 256)]:
        nmax = 512 // bs
        pos_list = [None if p is None else min(p, 512 - Tq)
                    for p in (0, 1, bs - 1, bs, 200, None, 512, 333)]
        q, k, v, ks, vs, tables, pos = paged_inputs(
            torch, da, gen, Tq, 16, Hkv, bs, nmax, kv, pos_list, hd)
        route = da.paged_route(Tq * 16 // Hkv, q.dtype, hd, k.dtype)
        before = (fn.tick_launches, fn.tc_launches)
        out = fn(q, k, v, tables, pos, ks, vs)
        ref = da._plain_paged(q, k, v, tables, pos, ks, vs, None)
        torch.cuda.synchronize()
        ran = (fn.tick_launches - before[0], fn.tc_launches - before[1])
        live = [b for b, p in enumerate(pos_list) if p is not None]
        err = (out[live].float() - ref[live].float()).abs().max().item()
        zero = not out[pos_list.index(None)].any().item()
        kg, vg, ksg, vsg = (None if x is None else
                            da.gather_paged_view(x, tables)
                            for x in (k, v, ks, vs))
        flat = da.decode_attention(q, kg, vg, pos, ksg, vsg)
        bits = torch.equal(out[live], flat[live])
        again = torch.equal(fn(q, k, v, tables, pos, ks, vs), out)
        log(f"  paged Hq=16 Hkv={Hkv} hd={hd} bs={bs} nmax={nmax} Tq={Tq} "
            f"{kv} ({route}): max|out-plain| {err:.3g} (tol "
            f"{BF16_TOL}*(1+|plain|)), free slot zero: {zero}, live slots "
            f"equal the contiguous kernel on the gathered copy: {bits}, "
            f"second call equal: {again}")
        if not (zero and bits and again and torch.allclose(
                out[live].float(), ref[live].float(), atol=BF16_TOL,
                rtol=BF16_TOL)):
            raise AssertionError(f"paged decode disagrees at bs={bs} "
                                 f"Hkv={Hkv} Tq={Tq} {kv}")
        if ran != (route == "tick", route == "tc"):
            raise AssertionError(f"paged decode at Tq={Tq} {kv} ran (tick, "
                                 f"tc) {ran}, route {route}")
        worst = max(worst, err)
    return worst


def check_flash_bwd(torch, fa):
    """dq, dk and dv of the backward kernels against ``_plain_bwd`` on the
    forward kernel's out and lse (bf16, tol 1e-2·(1 + |plain|)): the train
    path's shape first (B = 1, T = 2048, H = 16, D = 128, causal), then
    head_dim 64 and 256, causal and not, ragged T (77, 130, 200), S != T
    and GQA (G = 4).  Each launch on the route ``route_bwd`` names: one
    tensor-core launch of each kernel at head_dim 64 and 128, none at 256.
    Returns the worst errors of the dq kernel and of the dk/dv kernel."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst_q = worst_kv = 0.0
    for B, T, S, H, Hkv, D, causal in [(1, 2048, 2048, 16, 16, 128, True),
                                       (2, 200, 200, 16, 4, 128, True),
                                       (2, 200, 200, 16, 4, 64, False),
                                       (1, 512, 512, 16, 16, 64, True),
                                       (1, 77, 77, 8, 8, 128, True),
                                       (2, 130, 130, 16, 4, 128, True),
                                       (1, 200, 333, 8, 2, 128, False),
                                       (2, 333, 200, 8, 2, 64, False),
                                       (1, 77, 130, 4, 4, 128, True),
                                       (1, 200, 200, 8, 2, 256, True),
                                       (1, 512, 512, 8, 8, 256, False)]:
        q, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        before = (fa.flash_attention_bwd_dq.tc_launches,
                  fa.flash_attention_bwd_dkv.tc_launches)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
        tc = (fa.flash_attention_bwd_dq.tc_launches - before[0],
              fa.flash_attention_bwd_dkv.tc_launches - before[1])
        ref = fa._plain_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        got = (dq, dk, dv)
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(got, ref)]
        route = fa.route_bwd(q.dtype, D)
        log(f"  flash_bwd bf16 B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} "
            f"causal={causal} ({route}, tc launches dq/dkv {tc}): "
            f"max|d{{q,k,v}}-plain| "
            f"{', '.join(f'{e:.3g}' for e in errs)} "
            f"(tol {BF16_TOL}*(1+|plain|))")
        if not all(torch.allclose(g.float(), r.float(), atol=BF16_TOL,
                                  rtol=BF16_TOL) for g, r in zip(got, ref)):
            raise AssertionError(f"flash_bwd disagrees at T={T} S={S} D={D} "
                                 f"Hkv={Hkv} causal={causal}")
        if tc != ((route == "tc"),) * 2:
            raise AssertionError(f"flash_bwd at D={D} took {tc} tensor-core "
                                 f"launches on route {route}")
        worst_q, worst_kv = max(worst_q, errs[0]), max(worst_kv, *errs[1:])
    return worst_q, worst_kv


def check_ce(torch, fc):
    """The CE kernels against their plain twins on bf16 logits: the train
    path's loss head (N = 2048 rows, V = 50304), then ragged N = 37 with
    V = 1000 (16-byte rows) and V = 999 (the scalar walk); row 0's label
    lies outside the vocabulary and picks nothing.  Loss and lse within
    LSE_TOL; dlogits within CE_DX_ATOL + BF16_TOL·|plain|, both sides fed
    the kernel's lse.  Returns the worst errors (forward, backward)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst_f = worst_b = 0.0
    for N, V in [(2048, 50304), (37, 1000), (37, 999)]:
        x = (2 * torch.randn(N, V, generator=gen, device="cuda")).bfloat16()
        y = torch.randint(0, V, (N,), generator=gen, device="cuda")
        y[0] = -1
        dl = torch.randn(N, generator=gen, device="cuda")
        loss, lse = fc.ce_fwd(x, y)
        dx = fc.ce_bwd(x, y, lse, dl)
        ref_loss, ref_lse = fc._plain_ce_fwd(x, y)
        ref_dx = fc._plain_ce_bwd(x, y, lse, dl)
        torch.cuda.synchronize()
        e_f = max((loss - ref_loss).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        e_b = (dx.float() - ref_dx.float()).abs().max().item()
        log(f"  fused_ce bf16 N={N} V={V}: max|loss,lse - plain| {e_f:.3g} "
            f"(tol {LSE_TOL}), max|dlogits - plain| {e_b:.3g} (tol "
            f"{CE_DX_ATOL} + {BF16_TOL}*|plain|)")
        if not (e_f <= LSE_TOL and torch.allclose(
                dx.float(), ref_dx.float(), atol=CE_DX_ATOL, rtol=BF16_TOL)):
            raise AssertionError(f"fused CE disagrees at N={N} V={V}")
        worst_f, worst_b = max(worst_f, e_f), max(worst_b, e_b)
    return worst_f, worst_b


def _ln_inputs(torch, gen, N, F, dt, wdt):
    x = (2 * torch.randn(N, F, generator=gen, device="cuda") + 0.5).to(dt)
    g = (1 + 0.5 * torch.randn(F, generator=gen, device="cuda")).to(wdt)
    b = torch.randn(F, generator=gen, device="cuda").to(wdt)
    dy = torch.randn(N, F, generator=gen, device="cuda").to(dt)
    return x, g, b, dy


def _within(torch, got, ref, tol):
    """(max |got - ref|, every element within tol * (1 + |ref|))."""
    d = (got.float() - ref.float()).abs()
    return d.max().item(), bool((d <= tol * (1 + ref.float().abs())).all())


def check_norm(torch, fn):
    """The LayerNorm kernels against their plain twins: the train path's
    shape (N = 2048, F = 2048, bf16 x, fp32 g and b) first, then a decode
    tick's (bf16 g and b), ragged N and F in fp32 and bf16 (F = 999 takes
    the scalar walk), gpt_13b's width, and the forward's row groups: one
    row, F = 1, more rows than its persistent grid (N = 4099), 2-8 warps
    a row up to F = 8192, and the 760M rungs' train shape (N = 2048,
    F = 1536).  y and dx within BF16_TOL·(1 + |plain|) (fp32 x:
    LN_FP32_TOL); mu, rstd, dg and db within LN_FP32_TOL·(1 + |plain|),
    both sides of the backward fed the kernel's mu and rstd; a second
    forward and a second backward on the same inputs give the same bits.
    Returns the worst errors (forward y, backward dx)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    worst_f = worst_b = 0.0
    for N, F, dt, wdt in [(2048, 2048, bf, f32), (8, 2048, bf, bf),
                          (37, 1000, f32, f32), (37, 999, bf, f32),
                          (3, 5120, bf, f32), (1, 2048, bf, f32),
                          (7, 1, f32, bf), (4099, 2048, bf, f32),
                          (4099, 999, f32, f32), (7, 8192, f32, f32),
                          (7, 8192, bf, bf), (2048, 5120, bf, f32),
                          (2048, 1536, bf, f32)]:
        x, g, b, dy = _ln_inputs(torch, gen, N, F, dt, wdt)
        y, mu, r = fn.ln_fwd(x, g, b)
        dx, dg, db = fn.ln_bwd(x, g, mu, r, dy)
        ref_y, ref_mu, ref_r = fn._plain_ln_fwd(x, g, b)
        ref_dx, ref_dg, ref_db = fn._plain_ln_bwd(x, g, mu, r, dy)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == bf else LN_FP32_TOL
        e_y, ok_y = _within(torch, y, ref_y, tol)
        e_dx, ok_dx = _within(torch, dx, ref_dx, tol)
        stats = [_within(torch, a, b_, LN_FP32_TOL) for a, b_ in
                 ((mu, ref_mu), (r, ref_r), (dg, ref_dg), (db, ref_db))]
        log(f"  fused_norm x {str(dt)[6:]} g/b {str(wdt)[6:]} N={N} F={F}: "
            f"max|y-plain| {e_y:.3g}, max|dx-plain| {e_dx:.3g} (tol "
            f"{tol}*(1+|plain|)); max|mu, rstd, dg, db - plain| "
            f"{', '.join(f'{e:.3g}' for e, _ in stats)} (tol "
            f"{LN_FP32_TOL}*(1+|plain|))")
        if not (ok_y and ok_dx and all(ok for _, ok in stats)):
            raise AssertionError(f"fused LayerNorm disagrees at N={N} F={F}")
        again = fn.ln_bwd(x, g, mu, r, dy)      # sums in a fixed order
        if not all(torch.equal(a, b_) for a, b_ in zip(again, (dx, dg, db))):
            raise AssertionError(f"ln_bwd gave other bits on a second call "
                                 f"at N={N} F={F}")
        again = fn.ln_fwd(x, g, b)
        if not all(torch.equal(a, b_) for a, b_ in zip(again, (y, mu, r))):
            raise AssertionError(f"ln_fwd gave other bits on a second call "
                                 f"at N={N} F={F}")
        worst_f, worst_b = max(worst_f, e_y), max(worst_b, e_dx)
    return worst_f, worst_b


W4_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048)]   # gpt_1p3b (K, M)


def _w4_inputs(torch, woq, gen, N, K, M, dt, gs=64):
    q = torch.randint(-7, 8, (K, M), generator=gen, device="cuda")
    q[:2, :2] = torch.tensor([[-7, 7], [7, -7]])        # nibble extremes,
    q[K // 2:K // 2 + 2, :2] = torch.tensor([[-7, 7], [7, -7]])  # both halves
    packed = woq.pack_int4_halves(q)
    scale = 0.001 + 0.01 * torch.rand(K // gs, 1, M, generator=gen,
                                      device="cuda")
    x = torch.randn(N, K, generator=gen, device="cuda").to(dt)
    return x, packed, scale


def check_w4(torch, wm, woq):
    """The W4 kernel against ``_plain_w4`` for every gpt_1p3b weight shape
    (gs 64) at N = 1, 8 (a decode tick), 64, 128 and 256 (admission
    buckets, the last the kernel's cap), bf16 and fp32: bf16 within
    BF16_TOL·(1 + |plain|), fp32 within W4_FP32_TOL·(1 + |plain|), each
    launch on the body ``route`` names (bf16: the tensor-core body, counted
    in ``tc_launches``; fp32: the FMA body); and one-hot rows of x read
    back ``woq.w``'s dequantized weight bit for bit on both bodies.
    Returns the worst error."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    w4 = wm.w4_matmul
    for K, M in W4_SHAPES:
        for N in (1, 8, 64, 128, 256):
            for dt in (torch.bfloat16, torch.float32):
                x, packed, scale = _w4_inputs(torch, woq, gen, N, K, M, dt)
                body = wm.route(dt, N, K, M, 64)
                if body != ("tc" if dt == torch.bfloat16 else "fma"):
                    raise AssertionError(f"W4 route {body} for {dt}")
                before = w4.tc_launches
                out = w4(x, packed, scale)
                if w4.tc_launches - before != (body == "tc"):
                    raise AssertionError(f"w4_matmul at N={N} K={K} M={M} "
                                         f"{dt} did not run its {body} body")
                ref = wm._plain_w4(x, packed, scale)
                torch.cuda.synchronize()
                tol = BF16_TOL if dt == torch.bfloat16 else W4_FP32_TOL
                err, ok = _within(torch, out, ref, tol)
                if not ok:
                    raise AssertionError(f"w4_matmul disagrees at N={N} "
                                         f"K={K} M={M} {dt}")
                worst = max(worst, err)
        rows = torch.tensor([0, 1, K // 2, K - 1], device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            eye = torch.zeros(len(rows), K, dtype=dt, device="cuda")
            eye[torch.arange(len(rows)), rows] = 1
            w = woq.w({"w": packed, "w_s": scale}, "w", dt)[rows]
            if not torch.equal(wm.w4_matmul(eye, packed, scale), w):
                raise AssertionError(f"w4_matmul's weight is not woq.w's at "
                                     f"K={K} M={M} {dt}")
        log(f"  w4_matmul K={K} M={M} gs=64 N=1/8/64/128/256 bf16 (tc) / "
            f"fp32 (fma): max|out - plain| so far {worst:.3g} (tol "
            f"{BF16_TOL}*(1+|plain|) bf16, {W4_FP32_TOL}*(1+|plain|) fp32); "
            f"one-hot rows equal woq.w")
    return worst


def _small_models(torch, gpt):
    """(name, cfg, kv) of the small fp32 models the card-vs-CPU checks
    run: head_dim 128, MHA with learned positions and GQA with rope."""
    base = dict(vocab_size=512, hidden_size=256, num_layers=2,
                num_heads=2, max_seq_len=256, dtype=torch.float32)
    gqa = dict(num_heads=4, num_kv_heads=2, hidden_size=512,
               pos_embed="rope", activation="swiglu")
    for name, kw, kv in [("mha-learned", {}, ""), ("gqa-rope", gqa, ""),
                         ("mha-learned", {}, "int8"),
                         ("gqa-rope", gqa, "int8")]:
        yield name, gpt.GPTConfig(**{**base, **kw}), kv


def _leaves(params, prefix=""):
    """(dotted name, tensor) of every leaf of a (nested) parameter tree —
    an MoE model's ``blocks.moe.w_in`` included."""
    for n, v in params.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{n}.")
        else:
            yield prefix + n, v


def _tree_map(fn, params):
    """``fn`` applied to every leaf of a (nested) parameter tree."""
    return {n: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for n, v in params.items()}


def _to_card(params):
    """A copy of a CPU parameter tree on the card (nested subtrees, an MoE
    model's ``blocks["moe"]``, included)."""
    return _tree_map(lambda t: t.cuda(), params)


def _tree_bytes(params):
    """Bytes of every leaf of a (nested) parameter tree."""
    return sum(_tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in params.values())


def _prefill_decode_gap(torch, G, serving, cfg, cpu, card):
    """Prefill three prompts (5, 40 and 100 tokens, one slot each) and run
    five batched decode steps on the card and on the CPU from the same
    weights; returns the largest |logits card - cpu|."""
    worst = 0.0
    V = cfg.vocab_size
    caches = {"cpu": G.init_cache(cfg, 3, 160, "cpu"),
              "cuda": G.init_cache(cfg, 3, 160, "cuda")}
    rng = np.random.default_rng(0)
    lens = [5, 40, 100]
    for slot, n in enumerate(lens):
        toks = np.zeros((1, serving._pow2_bucket(n)), np.int64)
        toks[0, :n] = rng.integers(0, V, n)
        outs = {}
        for dev, p in (("cpu", cpu), ("cuda", card)):
            outs[dev], _ = G.prefill_slot(
                p, caches[dev], torch.from_numpy(toks).to(dev), n, slot, cfg)
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max()
                    .item())
    pos = np.array(lens, np.int32)
    for _ in range(5):
        tok = rng.integers(0, V, 3)
        outs = {}
        for dev, p in (("cpu", cpu), ("cuda", card)):
            outs[dev], _ = serving.decode_step_batched(
                p, caches[dev], torch.from_numpy(tok).to(dev),
                torch.from_numpy(pos).to(dev), cfg)
        d = (outs["cuda"].cpu() - outs["cpu"]).abs().max().item()
        assert np.isfinite(d)
        worst = max(worst, d)
        pos = pos + 1
    return worst


def check_path_vs_cpu(torch, gpt, G, serving):
    """Small fp32 models: prefill and batched-decode logits on the card
    (both kernels) against the CPU's plain paths."""
    worst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        cpu = gpt.init_params(cfg, seed=3, device="cpu")
        worst = max(worst, _prefill_decode_gap(torch, G, serving, cfg, cpu,
                                               _to_card(cpu)))
        log(f"  {name} kv={kv or 'fp32'}: max|logits card - cpu| so far "
            f"{worst:.3g} (tol {PATH_TOL})")
        if not worst <= PATH_TOL:
            raise AssertionError(f"card path disagrees with CPU on {name}")
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst


def check_quantized_vs_cpu(torch, gpt, G, serving, woq, wm):
    """Weight-only int8 and int4 small fp32 models (hidden 128, head_dim
    64; MHA with learned positions and GQA with rope and SwiGLU; int4 at
    group 32 and 64), quantized on the CPU and copied to the card: prefill
    and batched-decode logits with ``PADDLE_TPU_W4_KERNEL=1`` — on the
    card through the W4 kernel, which must have launched for every int4
    model — against the CPU's plain paths, within PATH_TOL."""
    os.environ["PADDLE_TPU_W4_KERNEL"] = "1"
    base = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                max_seq_len=256, dtype=torch.float32)
    gqa = dict(num_kv_heads=1, pos_embed="rope", activation="swiglu")
    worst = 0.0
    for name, kw, bits, gs in [("mha-learned", {}, 8, None),
                               ("mha-learned", {}, 4, 32),
                               ("gqa-rope", gqa, 4, 64),
                               ("gqa-rope", gqa, 8, None)]:
        cfg = gpt.GPTConfig(**{**base, **kw})
        float_cpu = gpt.init_params(cfg, seed=9, device="cpu")
        cpu = woq.quantize_gpt_int8(float_cpu) if bits == 8 \
            else woq.quantize_gpt_int4(float_cpu, group_size=gs)
        before = wm.w4_matmul.launches
        worst = max(worst, _prefill_decode_gap(torch, G, serving, cfg, cpu,
                                               _to_card(cpu)))
        launched = wm.w4_matmul.launches - before
        log(f"  {name} int{bits}{f' gs={gs}' if gs else ''}: max|logits "
            f"card - cpu| so far {worst:.3g} (tol {PATH_TOL}); "
            f"{launched} W4 launches")
        if not worst <= PATH_TOL:
            raise AssertionError(f"quantized card path disagrees with CPU on "
                                 f"{name} int{bits}")
        if (launched > 0) != (bits == 4):
            raise AssertionError(f"{launched} W4 launches on an int{bits} "
                                 f"model")
    os.environ.pop("PADDLE_TPU_W4_KERNEL", None)
    return worst


def check_paged_path_vs_cpu(torch, gpt, G, kv_pool, serving):
    """Small fp32 models: paged prefill chunks (several per prompt, the
    block-table kernel at Tq = 64 on the pool in place) and paged decode
    steps (its tick body) through shuffled tables with a free slot, on the
    card against the CPU's plain paths."""
    worst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        cpu = gpt.init_params(cfg, seed=5, device="cpu")
        card = _to_card(cpu)
        caches = {dev: G.init_cache(cfg, 4, 160, dev, layout="paged",
                                    block_size=16, num_blocks=24)
                  for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(1)
        lens = [5, 40, 100]                  # slot 3 stays free
        tables = np.full((4, 10), -1, np.int32)
        perm = rng.permutation(24).astype(np.int32)
        for slot, n in enumerate(lens):
            used = (n + 5 + 15) // 16
            tables[slot, :used] = perm[slot * 8:slot * 8 + used]
        for c in caches.values():
            c["tables"].copy_(torch.from_numpy(tables))
        for slot, n in enumerate(lens):
            toks = rng.integers(0, 512, n)
            for pos0 in range(0, n, 64):
                length = min(64, n - pos0)
                pad = np.zeros((1, 64), np.int64)
                pad[0, :length] = toks[pos0:pos0 + length]
                outs = {}
                for dev, p in (("cpu", cpu), ("cuda", card)):
                    outs[dev], _ = kv_pool.paged_prefill_chunk(
                        p, caches[dev], torch.from_numpy(pad).to(dev), pos0,
                        length, slot, cfg)
                worst = max(worst, (outs["cuda"].cpu() - outs["cpu"])
                            .abs().max().item())
        pos = np.array(lens + [0], np.int32)
        for _ in range(5):
            tok = rng.integers(0, 512, 4)
            outs = {}
            for dev, p in (("cpu", cpu), ("cuda", card)):
                outs[dev], _ = serving.decode_step_batched(
                    p, caches[dev], torch.from_numpy(tok).to(dev),
                    torch.from_numpy(pos).to(dev), cfg)
            d = (outs["cuda"][:3].cpu() - outs["cpu"][:3]).abs().max().item()
            assert np.isfinite(d)
            worst = max(worst, d)
            pos = pos + np.array([1, 1, 1, 0], np.int32)
        log(f"  paged {name} kv={kv or 'fp32'}: max|logits card - cpu| so "
            f"far {worst:.3g} (tol {PATH_TOL})")
        if not worst <= PATH_TOL:
            raise AssertionError(f"paged card path disagrees with CPU on "
                                 f"{name}")
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst


# the admission kinds' graph names (``text/engine.py``)
ADMISSION_GRAPHS = ("serving.prefill@", "serving.prefill_chunk@",
                    "serving.paged_prefill@", "serving.moe_prefill@",
                    "serving.moe_prefill_chunk@",
                    "serving.moe_paged_prefill@", "serving.adapter_prefill@",
                    "serving.adapter_prefill_chunk@",
                    "serving.adapter_paged_prefill@")


def admission_bits(torch, engine, srv, prompts):
    """From one cache state of ``srv`` (a graphed server; four of
    ``prompts`` admitted), each admission kind's graph against its eager
    body on the same binding — the contiguous bucket and chunk kinds, or
    the paged kind — at two feeds, the second another slot, offset and
    length (a replay after the feeds changed).  Returns {kind: logits and
    cache bit-equal at both}."""
    for p in prompts[:4]:
        srv.submit(p, max_new_tokens=12)
    slot_of = {len(st["prompt"]): s for s, st in srv._slots.items()}
    if srv._paged:      # rows the slots' tables map: [0, 112), [0, 48)
        cases = [("paged_prefill", dict(bucket=32),
                  [(64, 30, slot_of[100]), (16, 20, slot_of[40])])]
    else:
        cases = [("prefill", dict(bucket=64),
                  [(0, 40, slot_of[40]), (0, 17, slot_of[17])]),
                 ("prefill_chunk", dict(width=32),
                  [(32, 32, slot_of[100]), (64, 20, slot_of[40])])]
    rng = np.random.default_rng(5)
    out = {}
    for kind, kw, feeds in cases:
        spec = srv._spec(**kw)
        width = kw.get("bucket") or kw.get("width")
        eager = engine._Eager(engine._REGISTRY[kind].build(spec), srv._bind,
                              kind)
        graph = engine.ENGINE.get(kind, spec)
        same = True
        for pos0, length, slot in feeds:
            toks = rng.integers(0, srv.cfg.vocab_size, length).tolist()
            f = (srv._feeds(toks, width, length, slot) if kind == "prefill"
                 else srv._feeds(toks, width, pos0, length, slot))
            snap = {n: t.clone() for n, t in srv.cache.items()}
            want = eager(*f)[0].clone()
            want_cache = {n: t.clone() for n, t in srv.cache.items()}
            for n, t in srv.cache.items():
                t.copy_(snap[n])
            got = graph(*f)[0].clone()
            # a paged pool's sink block takes pad rows in no fixed order
            live = ((lambda n, c: c[n][:, :-1] if n != "tables" else c[n])
                    if srv._paged else (lambda n, c: c[n]))
            same = same and torch.equal(got, want) and all(
                torch.equal(live(n, srv.cache), live(n, want_cache))
                for n in snap)
        out[kind] = same
    srv.close()
    return out


def readmit_after_warmup(torch, make, prompt):
    """Serve ``prompt`` to the end on a fresh server from ``make``, warm it
    up, admit the prompt again (a paged server adopts its indexed
    blocks): the admission logits, against those of the same walk without
    the warmup.  True when bit-equal."""
    def run(warm):
        srv = make()
        serve(torch, srv, [prompt], 4)
        if warm:
            srv.warmup(prompt_lens=[len(prompt)])
        seen = []
        prefill = srv._prefill_slot
        srv._prefill_slot = lambda p, s, *a: seen.append(
            prefill(p, s, *a).clone()) or seen[-1]
        serve(torch, srv, [prompt], 4)
        srv.close()
        return seen[0]

    return torch.equal(run(True), run(False))


def check_graphs_vs_eager(torch, gpt, serving, woq, engine):
    """Small fp32 models served through the step Engine's graphs against
    eager steps (the private ``_graphs=False``) on the card: greedy
    streams of the graphed tick, tick_block(8) and async tick equal the
    eager tick's exactly (six requests of 5-100 tokens, four slots, 12
    new tokens); the captured step's logits sit within PATH_TOL of the
    eager step's from one cache state.  Contiguous (MHA with learned
    positions, GQA with rope), paged through shuffled block tables, int8
    KV, int4 weights with the W4 kernel.  Then admission: the budgeted
    (``prefill_budget=16``) graphed, block8 and async streams against the
    eager monolithic ones (equal, or leaving them on a PATH_TOL tie: the
    chunk route sums in another order than the bucket's flash); each
    admission kind's graph bit-equal to its eager body
    (:func:`admission_bits`); and re-admission after a drained server's
    warmup bit-equal to the same walk without it
    (:func:`readmit_after_warmup`; paged, sync and async).  Returns
    (worst logit gap, every step case bit-equal, every admission check
    held)."""
    base = dict(vocab_size=512, hidden_size=256, num_layers=2,
                num_heads=2, max_seq_len=256, dtype=torch.float32)
    gqa = dict(num_heads=4, num_kv_heads=2, hidden_size=512,
               pos_embed="rope", activation="swiglu")
    paged = dict(layout="paged", block_size=16, num_blocks=48)
    cases = [("mha-learned", {}, "", {}, None),
             ("gqa-rope", gqa, "", {}, None),
             ("mha-learned paged", {}, "", paged, None),
             ("gqa-rope int8 KV", gqa, "int8", {}, None),
             ("gqa-rope int8 KV paged", gqa, "int8", paged, None),
             ("mha-learned int4 W4", dict(hidden_size=128), "", {}, 32)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).tolist()
               for n in (5, 40, 100, 17, 60, 33)]
    worst, bits, admitted = 0.0, True, True
    for name, kw, kv, lay, gs in cases:
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        if gs:
            os.environ["PADDLE_TPU_W4_KERNEL"] = "1"
        cfg = gpt.GPTConfig(**{**base, **kw})
        params = gpt.init_params(cfg, seed=7, device="cuda")
        if gs:
            params = woq.quantize_gpt_int4(params, group_size=gs)

        def server(graphs, **extra):
            srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                                       device="cuda", _graphs=graphs, **lay,
                                       **extra)
            if lay:
                srv._pool._free = [int(b) for b in np.random.default_rng(
                    0).permutation(srv._pool.N)]
            return srv

        eager = server(False)
        ref = serve(torch, eager, prompts, 12)[0]
        eager.close()
        for way, extra, block in (("graph", {}, None), ("block8", {}, 8),
                                  ("async", dict(async_dispatch=True),
                                   None)):
            srv = server(True, **extra)
            got = serve(torch, srv, prompts, 12, block)[0]
            if got != ref:
                raise AssertionError(f"{name}: the {way} streams differ from "
                                     f"the eager tick's")
            if not engine.ENGINE.graphs(srv._bind):
                raise AssertionError(f"{name}: {way} served without graphs")
            srv.close()
        logits = []
        for graphs in (False, True):
            srv = server(graphs)
            for p in prompts[:4]:
                srv.submit(p, max_new_tokens=12)
            srv._ensure_decode_blocks(1)
            tok, pos = srv._feed_arrays()
            (out,) = engine.ENGINE.get("step", srv._spec())(
                srv._host(tok), srv._host(pos))
            logits.append(out.clone())
            srv.close()
        gap = (logits[1] - logits[0]).abs().max().item()
        same = torch.equal(logits[0], logits[1])
        worst, bits = max(worst, gap), bits and same
        log(f"  {name}: graph, block8 and async streams equal the eager "
            f"tick's; captured step logits {'bit-equal to' if same else ''}"
            f"{'' if same else f'{gap:.3g} from'} the eager step's (tol "
            f"{PATH_TOL})")
        if not gap <= PATH_TOL:
            raise AssertionError(f"{name}: captured logits {gap} from eager")
        long = sum(len(p) > 16 for p in prompts)
        for way, extra, block in (("graph", {}, None), ("block8", {}, 8),
                                  ("async", dict(async_dispatch=True),
                                   None)):
            srv = server(True, prefill_budget=16, **extra)
            got = serve(torch, srv, prompts, 12, block)[0]
            st = srv.stats()
            srv.close()
            for r in range(len(prompts)):
                check_tokens(torch, gpt, params, cfg, prompts[r], got[r],
                             ref[r], f"{name} budgeted {way} request {r}",
                             tol=PATH_TOL)
            if st["serving.admitting_claims"] != long \
                    or st["serving.prefill_chunks_interleaved"] <= long:
                raise AssertionError(f"{name} budgeted {way}: {st}")
        adm = admission_bits(torch, engine, server(True), prompts)
        c1 = {a: readmit_after_warmup(torch, lambda a=a: server(
                  True, async_dispatch=a), prompts[1])
              for a in ((False, True) if lay else (False,))}
        log(f"  {name}: budgeted graph, block8 and async streams held to "
            f"the eager monolithic ones; admission graphs bit-equal to "
            f"eager {adm}; re-admission after warmup bit-equal (async: "
            f"sync) {c1}")
        if not (all(adm.values()) and all(c1.values())):
            raise AssertionError(f"{name}: admission graphs {adm}, "
                                 f"re-admission after warmup {c1}")
        admitted = admitted and all(adm.values()) and all(c1.values())
        os.environ.pop("PADDLE_TPU_W4_KERNEL", None)
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst, bits, admitted


def check_train_vs_cpu(torch, gpt, gpt_hybrid, AdamW, fn):
    """Small fp32 models (head_dim 128, 2 layers, B = 4 of 64 tokens):
    five AdamW steps of ``build_gpt_train_step`` on the card (flash fwd
    and backward kernels; the CE kernels under PADDLE_TPU_FUSED_CE=1)
    against the same steps on the CPU (plain paths) from the same fp32
    masters and batches — MHA with learned positions and LayerNorm, GQA
    with rope, RMSNorm and SwiGLU; accum 1 and 2 (the bf16 gradient
    carry); one run with the log-softmax loss head; the LayerNorm runs
    again with PADDLE_TPU_FUSED_LN=1 (the LN kernels on the card, their
    twins on the CPU).  Losses within
    TRAIN_LOSS_TOL; final params within TRAIN_PARAM_TOL but for a
    TRAIN_PARAM_FAR share, and all within TRAIN_STEPS * TRAIN_LR."""
    base = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                max_seq_len=128, dtype=torch.float32)
    gqa = dict(num_heads=4, num_kv_heads=2, hidden_size=512,
               pos_embed="rope", norm="rmsnorm", activation="swiglu")
    worst_loss = worst_param = 0.0
    runs = [("mha-learned", {}, 1, "1"), ("mha-learned", {}, 2, "1"),
            ("gqa-rope", gqa, 1, "1"), ("gqa-rope", gqa, 2, "1"),
            ("mha-learned", {}, 1, "0")]
    # the LayerNorm runs again with the fused kernels (RMSNorm never
    # takes them, so the GQA runs would repeat themselves)
    runs = [r + ("0",) for r in runs] + [r + ("1",) for r in runs
                                         if r[0] == "mha-learned"]
    for name, kw, accum, ce, ln in runs:
        os.environ["PADDLE_TPU_FUSED_CE"] = ce
        os.environ["PADDLE_TPU_FUSED_LN"] = ln
        cfg = gpt.GPTConfig(**{**base, **kw})
        master = gpt.init_master_params(cfg, seed=7, device="cpu")
        rng = np.random.default_rng(3)
        batches = [rng.integers(0, cfg.vocab_size, (4, 65))
                   for _ in range(TRAIN_STEPS)]

        def run(dev, params):
            opt = AdamW(learning_rate=TRAIN_LR, weight_decay=0.01)
            _, step_fn, _ = gpt_hybrid.build_gpt_train_step(
                cfg, opt, accum=accum, device=dev)
            st = gpt_hybrid.GPTTrainState(
                params, opt.init_state(params),
                torch.zeros((), dtype=torch.int32, device=dev))
            losses = []
            for b in batches:
                st, loss = step_fn(st, b, None, TRAIN_LR)
                losses.append(loss.item())
            return losses, dict(_leaves(st.params))

        cpu_losses, cpu_params = run("cpu", master)
        ln_before = fn.ln_bwd.launches
        losses, params = run("cuda", _to_card(master))
        if (fn.ln_bwd.launches > ln_before) != (ln == "1"):
            raise AssertionError(f"fused LN flag {ln}: "
                                 f"{fn.ln_bwd.launches - ln_before} LN "
                                 f"backward launches")
        d_loss = max(abs(a - b) for a, b in zip(cpu_losses, losses))
        diff = torch.cat([(params[n].cpu() - t).abs().flatten()
                          for n, t in cpu_params.items()])
        d_param = diff.max().item()
        far = (diff > TRAIN_PARAM_TOL).float().mean().item()
        log(f"  {name} accum={accum} fused_ce={ce} fused_ln={ln}: losses "
            f"(card) "
            f"{[round(x, 5) for x in losses]}; max|loss card - cpu| "
            f"{d_loss:.3g} (tol {TRAIN_LOSS_TOL}); params card - cpu: max "
            f"{d_param:.3g} (tol {TRAIN_STEPS * TRAIN_LR}), share past "
            f"{TRAIN_PARAM_TOL} {far:.3g} of {diff.numel()} (tol "
            f"{TRAIN_PARAM_FAR})")
        if not (all(map(math.isfinite, losses))
                and d_loss <= TRAIN_LOSS_TOL and far <= TRAIN_PARAM_FAR
                and d_param <= TRAIN_STEPS * TRAIN_LR):
            raise AssertionError(f"card training disagrees with the CPU on "
                                 f"{name} accum={accum}")
        worst_loss, worst_param = max(worst_loss, d_loss), max(worst_param,
                                                               d_param)
    os.environ.pop("PADDLE_TPU_FUSED_CE", None)
    os.environ.pop("PADDLE_TPU_FUSED_LN", None)
    return worst_loss, worst_param


def train_runs_vs_cpu(torch, gpt, gpt_hybrid, base, runs):
    """Each run — (name, config fields over ``base``, a function making
    (optimizer, its scheduler or None: stepped after each train step),
    the steps' key, the run it equals or None, steps) — trained at accum
    2 from the seed-7 masters on B = 4 of 64 tokens, on the CPU and on
    the card, the step given no lr (the optimizer's own): losses within
    TRAIN_LOSS_TOL, final params within TRAIN_PARAM_TOL but for a
    TRAIN_PARAM_FAR share and all within TRAIN_STEPS * TRAIN_LR; a run
    naming another must be bit-equal to it on the card.  Returns
    ({name: (card losses, card params, config, masters, batches)}, the
    worst loss gap, the worst parameter gap)."""
    card_runs = {}
    worst_loss = worst_param = 0.0
    for name, kw, make_opt, key, same_as, steps in runs:
        cfg = gpt.GPTConfig(**{**base, **kw})
        master = gpt.init_master_params(cfg, seed=7, device="cpu")
        rng = np.random.default_rng(3)
        batches = [rng.integers(0, cfg.vocab_size, (4, 65))
                   for _ in range(steps)]

        def run(dev, params):
            opt, sched = make_opt()
            _, step_fn, _ = gpt_hybrid.build_gpt_train_step(
                cfg, opt, accum=2, device=dev)
            st = gpt_hybrid.GPTTrainState(
                params, opt.init_state(params),
                torch.zeros((), dtype=torch.int32, device=dev))
            losses = []
            for b in batches:
                st, loss = step_fn(st, b, key, None)
                losses.append(loss.item())
                if sched is not None:
                    sched.step()
            return losses, dict(_leaves(st.params))

        cpu_losses, cpu_params = run("cpu", master)
        losses, params = run("cuda", _to_card(master))
        card_runs[name] = losses, params, cfg, master, batches
        d_loss = max(abs(a - b) for a, b in zip(cpu_losses, losses))
        diff = torch.cat([(params[n].cpu() - t).abs().flatten()
                          for n, t in cpu_params.items()])
        d_param = diff.max().item()
        far = (diff > TRAIN_PARAM_TOL).float().mean().item()
        same = ""
        if same_as is not None:
            ref_losses, ref_params = card_runs[same_as][:2]
            bits = losses == ref_losses and all(
                torch.equal(t, ref_params[n]) for n, t in params.items())
            same = f"; card bit-equal to {same_as!r}: {bits}"
            if not bits:
                raise AssertionError(f"{name} on the card is not bit-equal "
                                     f"to {same_as}")
        log(f"  {name}: losses (card) {[round(x, 5) for x in losses]}; "
            f"max|loss card - cpu| {d_loss:.3g} (tol {TRAIN_LOSS_TOL}); "
            f"params card - cpu: max {d_param:.3g} (tol "
            f"{TRAIN_STEPS * TRAIN_LR}), share past {TRAIN_PARAM_TOL} "
            f"{far:.3g} of {diff.numel()} (tol {TRAIN_PARAM_FAR}){same}")
        if not (all(map(math.isfinite, losses))
                and d_loss <= TRAIN_LOSS_TOL and far <= TRAIN_PARAM_FAR
                and d_param <= TRAIN_STEPS * TRAIN_LR):
            raise AssertionError(f"card training disagrees with the CPU on "
                                 f"{name}")
        worst_loss = max(worst_loss, d_loss)
        worst_param = max(worst_param, d_param)
    return card_runs, worst_loss, worst_param


def check_train_surface_vs_cpu(torch, gpt, gpt_hybrid, optim, clip, lrs):
    """The rest of the training surface on small fp32 models (hidden 256,
    2 layers, head_dim 128, rope — a learned-position model's key bias
    has no gradient in exact arithmetic, and Adafactor would step it by
    the sign of each device's rounding noise — LayerNorm and the loss head
    on the fused kernels, B = 4 of 64 tokens, accum 2): five steps each of
    AdamW under no remat, full remat and "dots"; dropout 0.1 with a fixed
    key, without remat and under "dots"; Adafactor; Lamb; AdamW with a
    ``ClipGradByGlobalNorm``; AdamW on a ``LinearWarmup`` schedule (the
    step given no lr).  Each run on the card against the same run on the
    CPU (``check_train_vs_cpu``'s tolerances); on the card, each remat run
    bit-equal (losses and params) to its run without remat.  Returns the
    worst card-vs-CPU loss and parameter gaps."""
    os.environ["PADDLE_TPU_FUSED_CE"] = "1"
    os.environ["PADDLE_TPU_FUSED_LN"] = "1"
    base = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                max_seq_len=128, dtype=torch.float32, pos_embed="rope")

    def adamw(**kw):
        return optim.AdamW(**{"learning_rate": TRAIN_LR,
                              "weight_decay": 0.01, **kw}), None

    def warmup():
        sched = lrs.LinearWarmup(TRAIN_LR, warmup_steps=3,
                                 start_lr=TRAIN_LR / 4, end_lr=TRAIN_LR)
        return adamw(learning_rate=sched)[0], sched

    dots = dict(remat=True, remat_policy="dots")
    # name, config fields, (optimizer, its scheduler or None: stepped
    # after each train step), dropout key, the run it equals
    runs = [("adamw", {}, adamw, None, None),
            ("adamw full remat", dict(remat=True), adamw, None, "adamw"),
            ("adamw dots remat", dots, adamw, None, "adamw"),
            ("dropout 0.1", dict(dropout=0.1), adamw, 5, None),
            ("dropout 0.1 dots remat", dict(dots, dropout=0.1), adamw, 5,
             "dropout 0.1"),
            ("adafactor", {}, lambda: (optim.Adafactor(
                learning_rate=TRAIN_LR), None), None, None),
            ("lamb", {}, lambda: (optim.Lamb(learning_rate=TRAIN_LR), None),
             None, None),
            ("adamw global-norm clip", {}, lambda: adamw(
                grad_clip=clip.ClipGradByGlobalNorm(0.5)), None, None),
            ("adamw linear warmup", {}, warmup, None, None)]
    runs = [r + (TRAIN_STEPS,) for r in runs]
    card_runs, worst_loss, worst_param = train_runs_vs_cpu(
        torch, gpt, gpt_hybrid, base, runs)
    if card_runs["dropout 0.1"][0] == card_runs["adamw"][0]:
        raise AssertionError("dropout 0.1 left the losses as they were")
    os.environ.pop("PADDLE_TPU_FUSED_CE", None)
    os.environ.pop("PADDLE_TPU_FUSED_LN", None)
    return worst_loss, worst_param


def moe_train_small_vs_cpu(torch, gpt, gpt_hybrid, optim):
    """MoE training on a small fp32 model (hidden 256, 2 layers, head_dim
    128, rope, 4 top-2 experts at cf 1.25 with router noise 0.1, the
    LayerNorm and the loss head on the fused kernels, B = 4 of 64 tokens,
    accum 2), every step under a key: five AdamW steps without remat,
    under full remat and under "dots", and one step at cf 0.5, where
    assignments drop.  Each run on the card against the same run on the
    CPU (:func:`train_runs_vs_cpu`: the router noise is counter-based, so
    both devices draw the same bits); on the card, each remat run
    bit-equal (losses and params) to its run without remat.  Returns the
    worst card-vs-CPU loss and parameter gaps and the cf 0.5 step's
    routing of micro-batch 0."""
    from paddle_tpu_torch.text import moe

    os.environ["PADDLE_TPU_FUSED_CE"] = "1"
    os.environ["PADDLE_TPU_FUSED_LN"] = "1"
    base = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                max_seq_len=128, dtype=torch.float32, pos_embed="rope")

    def experts(cf=1.25):
        return moe.MoEConfig(num_experts=4, top_k=2, capacity_factor=cf,
                             router_noise=0.1)

    def adamw():
        return optim.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01), None

    key = 5
    runs = [("moe adamw", dict(moe=experts()), adamw, key, None,
             TRAIN_STEPS),
            ("moe full remat", dict(moe=experts(), remat=True), adamw, key,
             "moe adamw", TRAIN_STEPS),
            ("moe dots remat", dict(moe=experts(), remat=True,
                                    remat_policy="dots"), adamw, key,
             "moe adamw", TRAIN_STEPS),
            ("moe cf 0.5", dict(moe=experts(0.5)), adamw, key, None, 1)]
    card_runs, worst_loss, worst_param = train_runs_vs_cpu(
        torch, gpt, gpt_hybrid, base, runs)
    _, _, cfg, master, batches = card_runs["moe cf 0.5"]
    routing = moe_train_routing(torch, gpt, cfg, master,
                                torch.as_tensor(batches[0]), key)
    log(f"  moe cf 0.5: micro-batch 0 drops {routing['dropped']} of "
        f"{routing['dropped'] + routing['kept']} assignments")
    if routing["dropped"] == 0:
        raise AssertionError("cf 0.5 dropped no assignment")
    os.environ.pop("PADDLE_TPU_FUSED_CE", None)
    os.environ.pop("PADDLE_TPU_FUSED_LN", None)
    return {"cf0.5_routing": routing, "worst_loss": worst_loss,
            "worst_param": worst_param}


def time_flash(torch, fa, F, T):
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, H, D = 1, 16, 128
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
    flops = 4 * B * H * D * T * (T + 1) // 2        # causal pairs only
    b_ms, b_by = bound(nbytes, flops)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return {
        "shape": f"B={B} T={T} H={H} D={D} bf16 causal",
        "ms": cold_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True)),
        "plain_ms": cold_ms(torch, lambda: fa._plain_fwd(q, k, v, True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
    }


def held_to_plain(torch, out, ref, live, what):
    """max |out - ref| over the ``live`` slots; raises unless within
    BF16_TOL * (1 + |ref|) elementwise."""
    live = list(live)
    out, ref = out[live].float(), ref[live].float()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    log(f"  {what}: max|out-plain| {err:.3g} (tol {BF16_TOL}*(1+|plain|))")
    if not torch.allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL):
        raise AssertionError(f"{what}: the kernel disagrees with plain")
    return err


def time_decode(torch, da, F, pos_list, T=512, Tq=1):
    """The decode kernel at a tick's shape (Tq = 1) or a speculative
    verify's (Tq = K rows a slot, each seeing the cache through its own
    position): B = len(pos_list) slots, Hq = Hkv = 16, hd 128, bf16.
    Bytes: each slot's live K/V rows, q and out; operations: the visible
    (query, key) pairs.  At Tq > 1 the kernel's output is held against the
    plain version's on these inputs first (``max_abs_err``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, Hq, Hkv, hd = len(pos_list), 16, 16, 128
    q = torch.randn(B, Tq, Hq, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    live = sum(min(T, p + Tq) for p in pos_list)     # rows this data needs
    pairs = sum(Tq * p + Tq * (Tq + 1) // 2 for p in pos_list)
    nbytes = live * Hkv * hd * 2 * 2 + 2 * q.numel() * 2 + B * 4
    flops = 4 * pairs * Hq * hd
    b_ms, b_by = bound(nbytes, flops)
    mask = (torch.arange(T, device="cuda")[None, None, :]
            <= pos[:, None, None] + torch.arange(Tq, device="cuda")[:, None]
            )[:, None]                               # [B, 1, Tq, T]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    err = {} if Tq == 1 else {"max_abs_err": held_to_plain(
        torch, da.decode_attention(q, k, v, pos),
        da._plain_decode(q, k, v, pos, None, None, None), range(B),
        f"decode timed at Tq={Tq} pos={pos_list}")}
    return {
        "shape": f"B={B} Tq={Tq} Hq={Hq} Hkv={Hkv} hd={hd} T={T} bf16 "
                 f"pos={pos_list}", **err,
        "ms": cold_ms(torch, lambda: da.decode_attention(q, k, v, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_decode(
            q, k, v, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
    }


def time_decode_chunk(torch, da, F, Tq=512, T=512):
    """The decode kernel at an admission chunk's width: one slot, Tq query
    rows at the end of a T-row cache (pos = T - Tq; Hq = Hkv = 16, hd 128,
    bf16), each row seeing the cache through its own position.  Bytes:
    the T live K/V rows, q and out; operations: the visible pairs."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    Hq = Hkv = 16
    hd, pos0 = 128, T - Tq
    q, k, v = (torch.randn(1, n, h, hd, generator=gen, device="cuda")
               .to(torch.bfloat16) for n, h in ((Tq, Hq), (T, Hkv), (T, Hkv)))
    pos = torch.full((1,), pos0, dtype=torch.int32, device="cuda")
    nbytes = T * Hkv * hd * 2 * 2 + 2 * q.numel() * 2 + 4
    pairs = Tq * pos0 + Tq * (Tq + 1) // 2
    b_ms, b_by = bound(nbytes, 4 * Hq * hd * pairs)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos0 + torch.arange(Tq, device="cuda")[:, None])
    lib = (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
           ) if pos0 == 0 else (lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask))
    return {
        "shape": f"B=1 Tq={Tq} Hq={Hq} Hkv={Hkv} hd={hd} T={T} bf16 "
                 f"pos={pos0} (R={Tq * Hq // Hkv}, "
                 f"{da.route(Tq * Hq // Hkv, q.dtype, hd)} route)",
        "ms": cold_ms(torch, lambda: da.decode_attention(q, k, v, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_decode(
            q, k, v, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lib),
    }


def time_paged(torch, da, F, pos_list, Tq=1):
    """The paged kernel at the paged path's shapes: Hq = Hkv = 16, hd =
    128, bs = 16, nmax = 32, bf16, every slot's blocks distinct and
    shuffled — the mid-serve tick (B = 8, Tq = 1) or an admission chunk
    (one slot, Tq = C query rows).  Bound: the live K/V rows, the tables,
    q and the output; operations: the visible (query, key) pairs.
    Yardstick: SDPA on a pre-gathered contiguous copy (``gather_ms`` times
    the gather of K and V on its own).  At Tq > 1 the kernel's output is
    held against the plain version's on these inputs first
    (``max_abs_err``)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bs, nmax, Hq, hd = 16, 32, 16, 128
    q, k, v, _, _, tables, pos = paged_inputs(
        torch, da, gen, Tq, Hq, Hq, bs, nmax, "bf16", pos_list)
    B, T = len(pos_list), nmax * bs
    live = sum(min(T, p + Tq) for p in pos_list)
    pairs = sum(Tq * p + Tq * (Tq + 1) // 2 for p in pos_list)
    nbytes = (live * Hq * hd * 2 * 2 + 2 * q.numel() * 2 + B * 4
              + tables.numel() * 4)
    b_ms, b_by = bound(nbytes, 4 * Hq * hd * pairs)
    kg, vg = (da.gather_paged_view(x, tables) for x in (k, v))
    mask = (torch.arange(T, device="cuda")[None, None, :]
            <= pos[:, None, None] + torch.arange(Tq, device="cuda")[:, None]
            )[:, None]                              # [B, 1, Tq, T]
    qt, kt, vt = q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2)
    err = {} if Tq == 1 else {"max_abs_err": held_to_plain(
        torch, da.paged_decode_attention(q, k, v, tables, pos),
        da._plain_paged(q, k, v, tables, pos, None, None, None), range(B),
        f"paged decode timed at Tq={Tq} pos={pos_list}")}
    return {
        "shape": f"B={B} Tq={Tq} Hq={Hq} Hkv={Hq} hd={hd} bs={bs} "
                 f"nmax={nmax} bf16 pos={pos_list}", **err,
        "ms": cold_ms(torch, lambda: da.paged_decode_attention(
            q, k, v, tables, pos)),
        "plain_ms": cold_ms(torch, lambda: da._plain_paged(
            q, k, v, tables, pos, None, None, None)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        "gather_ms": cold_ms(torch, lambda: (da.gather_paged_view(k, tables),
                                             da.gather_paged_view(v, tables))),
    }


def time_paged_addressing(torch, da, pos_list, Tq=1):
    """What the block tables cost the paged kernel: the contiguous kernel
    on a cache [B, 512, 16, 128] bf16 against the paged kernel on the
    same memory viewed as a pool of 16-row blocks (identity tables), and
    on a shuffled copy of it — the same rows, bits and work, so the
    difference is the table's resolution alone (tick: B = 8, Tq = 1;
    admission: one slot, Tq = C)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bs, nmax, H, hd = 16, 32, 16, 128
    B, T = len(pos_list), bs * nmax
    q = torch.randn(B, Tq, H, hd, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, T, H, hd, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    kp, vp = (x.view(B * nmax, bs, H, hd) for x in (k, v))
    ident = torch.arange(B * nmax, dtype=torch.int32,
                         device="cuda").view(B, nmax)
    perm = torch.randperm(B * nmax, generator=gen, device="cuda").int()
    k_shuf, v_shuf = torch.empty_like(kp), torch.empty_like(vp)
    k_shuf[perm.long()] = kp
    v_shuf[perm.long()] = vp
    perm = perm.view(B, nmax)
    flat = da.decode_attention(q, k, v, pos)
    return {
        "shape": f"B={B} Tq={Tq} Hq=Hkv={H} hd={hd} bs={bs} nmax={nmax} "
                 f"bf16 pos={pos_list}",
        "contiguous_ms": cold_ms(torch, lambda: da.decode_attention(
            q, k, v, pos)),
        "paged_identity_ms": cold_ms(torch, lambda: da.paged_decode_attention(
            q, kp, vp, ident, pos)),
        "paged_shuffled_ms": cold_ms(torch, lambda: da.paged_decode_attention(
            q, k_shuf, v_shuf, perm, pos)),
        "bits_equal": all(
            torch.equal(da.paged_decode_attention(q, kk, vv, tt, pos), flat)
            for kk, vv, tt in ((kp, vp, ident), (k_shuf, v_shuf, perm))),
    }


def time_flash_bwd(torch, fa, F, T=2048):
    """The dq and dk/dv kernels at one train micro-batch (B = 1, T = 2048,
    H = 16, D = 128, bf16, causal).  Bounds count the causal pairs only.
    The plain twin and the yardstick (the backward of SDPA on the same q,
    k, v and do) each compute dq, dk and dv in one call, so both rows
    carry those whole times."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, H, D = 1, 16, 128
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    pairs = B * H * T * (T + 1) // 2
    act, rows = B * T * H * D * 2, B * H * T * 4    # one bf16 [B,T,H,D]; lse
    # dq reads q k v out do lse, writes dq and delta; dk/dv reads q k v do
    # lse delta, writes dk dv.  Products: dq 3 of 2·D each per pair, dk/dv 4
    dq_ms, dq_by = bound(6 * act + 2 * rows, 6 * D * pairs)
    dkv_ms, dkv_by = bound(6 * act + 2 * rows, 8 * D * pairs)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    shared = {
        "shape": f"B={B} T={T} H={H} D={D} bf16 causal",
        "route": fa.route_bwd(q.dtype, D),
        "plain_ms": cold_ms(torch, lambda: fa._plain_bwd(
            q, k, v, out, lse, do, True)),
        "library_ms": cold_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True)),
        "plain_and_library_compute": "dq, dk and dv",
    }
    return {
        "dq": {**shared, "bound_ms": dq_ms, "bound_by": dq_by,
               "ms": cold_ms(torch, lambda: fa.flash_attention_bwd_dq(
                   q, k, v, out, lse, do, True))},
        "dkv": {**shared, "bound_ms": dkv_ms, "bound_by": dkv_by,
                "ms": cold_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, delta, do, True))},
    }


def time_ce(torch, fc, F, N=2048, V=50304):
    """The CE kernels at the train path's loss head: one micro-batch's
    N = 2048 rows of V = 50304 bf16 logits, dloss = 1/N (the mean's).
    Yardstick: ``F.cross_entropy(reduction="none")`` and its backward.
    Operations (max, subtract, exp, add per logit) count at the fp32 rate;
    the bytes bound both."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = (2 * torch.randn(N, V, generator=gen, device="cuda")).bfloat16()
    y = torch.randint(0, V, (N,), generator=gen, device="cuda")
    dl = torch.full((N,), 1.0 / N, device="cuda")
    _, lse = fc.ce_fwd(x, y)
    xg = x.detach().requires_grad_()
    lt = F.cross_entropy(xg, y, reduction="none")
    shape = f"N={N} V={V} bf16"
    f_ms, f_by = bound(N * V * 2 + N * (8 + 4 + 4), 4 * N * V,
                       FP32_FLOPS_PER_S)
    b_ms, b_by = bound(2 * N * V * 2 + N * (8 + 4 + 4), 4 * N * V,
                       FP32_FLOPS_PER_S)
    return {
        "fwd": {"shape": shape, "bound_ms": f_ms, "bound_by": f_by,
                "ms": cold_ms(torch, lambda: fc.ce_fwd(x, y)),
                "plain_ms": cold_ms(torch, lambda: fc._plain_ce_fwd(x, y)),
                "library_ms": cold_ms(torch, lambda: F.cross_entropy(
                    x, y, reduction="none"))},
        "bwd": {"shape": shape, "bound_ms": b_ms, "bound_by": b_by,
                "ms": cold_ms(torch, lambda: fc.ce_bwd(x, y, lse, dl)),
                "plain_ms": cold_ms(torch, lambda: fc._plain_ce_bwd(
                    x, y, lse, dl)),
                "library_ms": cold_ms(torch, lambda: torch.autograd.grad(
                    lt, xg, dl, retain_graph=True))},
    }


def time_norm(torch, fn, F, N=2048, D=2048):
    """The LayerNorm kernels at the train path's shape: one micro-batch's
    N = 2048 rows of D = 2048, bf16 x and dy, fp32 g and b.  Bytes: the
    forward reads x, g, b and writes y, mu, rstd; the backward reads x,
    dy, g, mu, rstd and writes dx, dg, db.  Operations (about 8 a forward
    element, 12 a backward one) count at the fp32 rate.  Yardstick:
    ``F.layer_norm`` and its backward (x, weight and bias grads) on the
    same x and dy, with bf16 copies of g and b (one dtype for all three).
    :func:`ln_bwd_apart` times the backward's two kernels apart."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    x, g, b, dy = _ln_inputs(torch, gen, N, D, torch.bfloat16, torch.float32)
    _, mu, r = fn.ln_fwd(x, g, b)
    gb, bb = g.bfloat16(), b.bfloat16()
    xl, gl, bl = (t.detach().requires_grad_() for t in (x, gb, bb))
    yl = F.layer_norm(xl, (D,), gl, bl, 1e-5)
    act = N * D * 2
    f_ms, f_by = bound(2 * act + 2 * D * 4 + 2 * N * 4, 8 * N * D,
                       FP32_FLOPS_PER_S)
    b_ms, b_by = bound(3 * act + 3 * D * 4 + 2 * N * 4, 12 * N * D,
                       FP32_FLOPS_PER_S)
    shape = f"N={N} F={D} bf16 x, fp32 g/b"
    return {
        "fwd": {"shape": shape, "bound_ms": f_ms, "bound_by": f_by,
                "ms": cold_ms(torch, lambda: fn.ln_fwd(x, g, b)),
                "plain_ms": cold_ms(torch, lambda: fn._plain_ln_fwd(x, g, b)),
                "library_ms": cold_ms(torch, lambda: F.layer_norm(
                    x, (D,), gb, bb, 1e-5))},
        "bwd": {"shape": shape, "bound_ms": b_ms, "bound_by": b_by,
                "ms": cold_ms(torch, lambda: fn.ln_bwd(x, g, mu, r, dy)),
                "plain_ms": cold_ms(torch, lambda: fn._plain_ln_bwd(
                    x, g, mu, r, dy)),
                "library_ms": cold_ms(torch, lambda: torch.autograd.grad(
                    yl, (xl, gl, bl), dy, retain_graph=True)),
                "ctas_rows_each":
                    fn.bwd_plan(N, fn._sm_count(x.device))[::-1]},
    }


def ln_bwd_apart(torch, fn, N=2048, D=2048):
    """The LayerNorm backward's two kernels on :func:`time_norm`'s inputs,
    timed apart by name in a profile of the call (:func:`kernel_ms`): the
    row pass (``rows_ms``) and the column sum of dg/db (``cols_ms``).  It
    runs after the paths, so the profiler touches no path's timing."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    x, g, b, dy = _ln_inputs(torch, gen, N, D, torch.bfloat16, torch.float32)
    _, mu, r = fn.ln_fwd(x, g, b)
    return kernel_ms(torch, lambda: fn.ln_bwd(x, g, mu, r, dy),
                     {"rows_ms": "ln_bwd_rows_kernel",
                      "cols_ms": "ln_bwd_cols_kernel"})


def time_w4(torch, wm, woq, N, K, M):
    """The W4 kernel at one gpt_1p3b weight shape (gs 64, bf16 x).  Bytes:
    the packed weight, its fp32 scales, x and the output; operations
    2·N·K·M at the bf16 tensor-core rate.  Yardstick: a bf16 ``matmul``
    on the weight dequantized beforehand (it reads 4x the weight bytes)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    x, packed, scale = _w4_inputs(torch, woq, gen, N, K, M, torch.bfloat16)
    wdq = woq.w({"w": packed, "w_s": scale}, "w", torch.bfloat16)
    b_ms, b_by = bound(packed.numel() + scale.numel() * 4 + x.numel() * 2
                       + N * M * 2, 2 * N * K * M)
    body = wm.route(x.dtype, N, K, M, 64)
    splits = wm.splits_for(N, K, M, wm._sm_count(x.device), body)
    return {
        "shape": f"N={N} K={K} M={M} gs=64 bf16 ({body} body, splits "
                 f"{splits})",
        "ms": cold_ms(torch, lambda: wm.w4_matmul(x, packed, scale)),
        "plain_ms": cold_ms(torch, lambda: wm._plain_w4(x, packed, scale)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cold_ms(torch, lambda: torch.matmul(x, wdq)),
    }


def counters(fa, da, fc, fn, wm):
    """Every kernel wrapper of the port, by the name the kernels line
    gives it; each carries its ``launches`` count."""
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_ce_fwd": fc.ce_fwd, "fused_ce_bwd": fc.ce_bwd,
            "fused_layer_norm_fwd": fn.ln_fwd,
            "fused_layer_norm_bwd": fn.ln_bwd,
            "w4_matmul": wm.w4_matmul,
            "decode_attention": da.decode_attention,
            "paged_decode_attention": da.paged_decode_attention}


def launch_counts(ks):
    return {name: fn.launches for name, fn in ks.items()}


def tc_counts(ks):
    """Launches on the tensor-core bodies, for the wrappers that have them."""
    return {name: fn.tc_launches for name, fn in ks.items()
            if hasattr(fn, "tc_launches")}


def tick_counts(ks):
    """Launches on the tick body (both decode kernels below ``R_TC``)."""
    return {name: fn.tick_launches for name, fn in ks.items()
            if hasattr(fn, "tick_launches")}


def zero_counts(ks):
    for fn in ks.values():
        fn.launches = 0
        for attr in ("tc_launches", "tick_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def serve(torch, srv, prompts, new, block=None, **sub):
    """Submit every prompt (``sub``: more ``submit`` options), then
    ``tick()`` (or ``tick_block(block)``) until drained; returns (tokens
    per request, admission seconds, per-call seconds, wall seconds)."""
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=new, **sub) for p in prompts]
    t_admit = time.perf_counter() - t0
    ticks = []
    while srv.pending():
        t1 = time.perf_counter()
        srv.tick_block(block) if block else srv.tick()
        ticks.append(time.perf_counter() - t1)
        if len(ticks) > 10 * new:
            raise AssertionError("server did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [srv.result(r) for r in rids], t_admit, ticks, wall


def check_tokens(torch, gpt, params, cfg, prompt, got, ref, what,
                 tol=TIE_TOL):
    """``got`` equals the reference stream ``ref`` (both greedy
    continuations of ``prompt``), or first leaves it on a tie: in a
    teacher-forced forward over prompt + ref, the logit of got's token at
    the divergence is within ``tol`` of the best (TIE_TOL, a bf16 tie; on
    the small fp32 models PATH_TOL, the logit gap two correct routes may
    show).  Returns None when equal, else (index, gap) — gap = best logit
    - got's logit there."""
    if got == ref:
        return None
    i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
    seq = torch.tensor([prompt + ref[:i + 1]], device="cuda")
    row = gpt.forward(params, seq, cfg)[0, len(prompt) - 1 + i].float()
    gap = (row.max() - row[got[i]]).item()
    log(f"  {what}: leaves the reference at token {i} of {len(ref)} on a "
        f"logit {gap:.4g} under the best (tie tolerance {tol})")
    if not gap <= tol:
        raise AssertionError(f"{what}: differs from the reference at token "
                             f"{i}: {got[:i + 3]} vs {ref[:i + 3]}, logit "
                             f"gap {gap}")
    return i, gap


def forced_gap(torch, gpt, params, cfg, prompt, got):
    """The largest, over every token of the greedy stream ``got``, of the
    best logit less got's logit in a teacher-forced forward over prompt +
    got: 0 for a stream that is the forward's argmax throughout, a bf16
    tie's step where a route broke a tie the other way."""
    seq = torch.tensor([prompt + got[:-1]], device="cuda")
    with torch.no_grad():
        rows = gpt.forward(params, seq, cfg)[0, len(prompt) - 1:].float()
    idx = torch.tensor(got, device="cuda")[:, None]
    return (rows.max(-1).values - rows.gather(1, idx)[:, 0]).max().item()


def check_solo(torch, gpt, G, params, cfg, prompt, served, new):
    """``served`` against a solo ``generate`` of ``prompt`` by the tie
    rule; then the generate cache the Engine keeps (with a reference to
    ``params``) is purged, so the path's weights leave the card with it.
    Called with every server of ``cfg`` closed."""
    from paddle_tpu_torch.text import engine

    solo = G.generate(params, cfg, [prompt], new, device="cuda")
    engine.ENGINE.purge(cfg)
    return check_tokens(torch, gpt, params, cfg, prompt, served,
                        solo[0, len(prompt):].tolist(), "vs solo generate")


# the ways each serving path's requests are served besides the gated
# graphed tick: (name, server options, tick_block size)
WAYS = (("eager", dict(_graphs=False), None), ("block8", {}, 8),
        ("async", dict(async_dispatch=True), None))


def way_stats(torch, engine, srv, served, t_admit, ticks, wall, peak, warm,
              block=None):
    """One way's numbers: tokens/s over the serve's wall, per-call ms
    (a call: one tick, or one tick_block of ``block`` steps), admission
    ms (the submits), peak memory, the server's graphs and its warmup.
    ``reserved_gb``: the caching allocator's memory with the server alive
    and the free cached blocks dropped — weights, cache and every graph's
    private pool, which ``max_memory_allocated`` does not see once its
    capture has freed its transients into the pool."""
    n_tok = sum(len(s) for s in served)
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "calls": len(ticks), "steps_per_call": block or 1,
            "tick_ms_mean": 1e3 * statistics.mean(ticks),
            "tick_ms_median": 1e3 * statistics.median(ticks),
            "admission_ms": 1e3 * t_admit, "peak_mem_gb": peak / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "graphs": len(engine.ENGINE.graphs(srv._bind)),
            "warmup_s": sum(warm.values())}


def step_replays(engine, srv, step="serving.step"):
    """Replays of the server's step graph ``step`` so far (0 before its
    capture)."""
    return sum(g.replays for g in engine.ENGINE.graphs(srv._bind)
               if g.name == step)


def admission_replays(engine, srv):
    """Replays of the server's admission graphs so far."""
    return sum(g.replays for g in engine.ENGINE.graphs(srv._bind)
               if g.name.startswith(ADMISSION_GRAPHS))


def replays_now(engine, srv, step="serving.step"):
    """(step, admission) replays of ``srv``'s graphs so far: read after
    warmup, the baseline :func:`graphed_serve` counts from."""
    return step_replays(engine, srv, step), admission_replays(engine, srv)


def graphed_serve(torch, engine, srv, ticks, replays0, admissions,
                  step="serving.step"):
    """The gated serve went through captured graphs: the server's step
    graph (``step``: an MoE server's is ``serving.moe_step``) replayed
    once a tick, and an admission graph once an admission call
    (``admissions``: the serve's prefill and chunk calls); ``replays0``:
    :func:`replays_now` before the serve, after the warmup's.  Returns the
    server's graph count."""
    graphs = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    replays = step_replays(engine, srv, step) - replays0[0]
    adm = admission_replays(engine, srv) - replays0[1]
    if replays != len(ticks) or adm != admissions:
        raise AssertionError(f"the serve's {len(ticks)} ticks replayed the "
                             f"step graph {replays} times and its "
                             f"{admissions} admission calls the admission "
                             f"graphs {adm} times (graphs: "
                             f"{sorted(graphs)})")
    return len(graphs)


def admission_profiles(torch, wl, path, params, cfg, prompts):
    """One admission of ``path``, eager and graphed
    (``profile_serving.profile_admission``): wall (profiled and not),
    device ms and kernel launches of each, logged; returns {arm: row}."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rows = {}
    for arm in ("eager", "graph"):
        gc.collect()
        torch.cuda.empty_cache()
        rows[arm] = r = wl.profile_admission(torch, path, params, cfg,
                                             prompts, arm, acts)
        log(f"  {path} admission, {arm}: wall {r['unprofiled_wall_ms']:.3f} "
            f"ms ({r['wall_ms']:.3f} profiled), device "
            f"{r['device_ms']:.3f} ms, {r['launches']:.0f} launches "
            f"({r['what']})")
    return rows


def serving_ways(torch, gpt, engine, wl, path, cfg, params, prompts, new,
                 graph_served, graph_stats):
    """The gated serve's requests served the other ways of ``WAYS`` — eager
    ticks, graphed tick_block(8), graphed async ticks — one fresh server
    each on the same weights (warmed up, then closed); every graphed
    way's streams held to the eager ones by the tie rule.  Returns
    {way: stats}."""
    lens = [len(p) for p in prompts]
    ways, streams = {"graph": graph_stats}, {"graph": graph_served}
    for name, kw, block in WAYS:
        gc.collect()
        torch.cuda.empty_cache()
        srv = wl.make_server(path, params, cfg, **kw)
        warm = srv.warmup(prompt_lens=lens, blocks=(block,) if block else ())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        served, t_admit, ticks, wall = serve(torch, srv, prompts, new, block)
        ways[name] = way_stats(torch, engine, srv, served, t_admit, ticks,
                               wall, torch.cuda.max_memory_allocated(), warm,
                               block)
        streams[name] = served
        srv.close()
    if ways["eager"]["graphs"] or not all(ways[w]["graphs"] for w in
                                          ("graph", "block8", "async")):
        raise AssertionError(f"{path}: graphs per way "
                             f"{ {w: v['graphs'] for w, v in ways.items()} }")
    for name in ("graph", "block8", "async"):
        div = {r: check_tokens(torch, gpt, params, cfg, prompts[r],
                               streams[name][r], streams["eager"][r],
                               f"{path} {name} request {r} vs eager")
               for r in range(len(prompts))}
        ways[name]["eager_equal"] = all(d is None for d in div.values())
        ways[name]["eager_divergences"] = {r: d for r, d in div.items()
                                           if d is not None}
    for name, w in ways.items():
        log(f"  {path} {name}: tokens/s {w['tokens_per_s']:.1f}, tick ms "
            f"mean {w['tick_ms_mean']:.2f} median {w['tick_ms_median']:.2f} "
            f"({w['steps_per_call']}-step calls), admission "
            f"{w['admission_ms']:.1f} ms, peak {w['peak_mem_gb']:.4f} GB, "
            f"reserved {w['reserved_gb']:.4f} GB "
            f"({1e3 * (w['reserved_gb'] - ways['eager']['reserved_gb']):+.1f}"
            f" MB over eager), {w['graphs']} graphs, warmup "
            f"{w['warmup_s']:.3f} s")
    return ways


def main_path(torch, gpt, G, serving, engine, ks, wl):
    from paddle_tpu_torch import telemetry as tl

    cfg, params, srv, prompts = wl.build_main_path("cuda", seed=0)
    n_params = sum(t.numel() for n, t in params.items() if n != "blocks") \
        + sum(t.numel() for t in params["blocks"].values())
    assert n_params == gpt.count_params(cfg)
    assert params["wte"].dtype == torch.bfloat16
    log(f"  gpt_1p3b: {n_params} params, "
        f"{2 * n_params / 1e9:.3f} GB in bf16")
    lens, new = wl.LENS, wl.NEW
    buckets = sorted({serving._pow2_bucket(n, 512) for n in lens})
    assert buckets == [64, 128, 256, 512], buckets
    since = time.time()
    warm = srv.warmup(prompt_lens=lens)
    replays0 = replays_now(engine, srv)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ks)
    served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
    launches = launch_counts(ks)
    tc = tc_counts(ks)
    tick = tick_counts(ks)
    peak = torch.cuda.max_memory_allocated()
    n_graphs = graphed_serve(torch, engine, srv, ticks, replays0,
                             len(prompts))
    n_tok = sum(len(s) for s in served)
    log(f"  served {len(served)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission prefill {t_admit * 1e3:.1f} ms, "
        f"each admission one replay of its bucket's graph)")
    log(f"  launches in the main path: {launches}; on tensor-core bodies: "
        f"{tc}; on the tick body: {tick}")
    if not (launches["flash_attention_fwd"] and launches["decode_attention"]):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    assert launches["flash_attention_fwd"] == cfg.num_layers * len(prompts)
    assert launches["decode_attention"] == cfg.num_layers * len(ticks)
    assert launches["paged_decode_attention"] == 0
    # bf16 prefill runs the tensor-core flash body; every tick (R = 1) the
    # tick decode body
    assert tc == {"flash_attention_fwd": launches["flash_attention_fwd"],
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                  "w4_matmul": 0, "decode_attention": 0,
                  "paged_decode_attention": 0}, tc
    if tick["decode_attention"] != launches["decode_attention"]:
        raise AssertionError(f"{tick['decode_attention']} of "
                             f"{launches['decode_attention']} tick launches "
                             f"on the tick body")
    assert all(len(s) == new and all(0 <= t < cfg.vocab_size for t in s)
               for s in served)
    feed = feed_gates(tl, cfg, "main graph serve", since)
    graph_way = way_stats(torch, engine, srv, served, t_admit, ticks, wall,
                          peak, warm)
    srv.close()
    ways = serving_ways(torch, gpt, engine, wl, "main", cfg, params, prompts,
                        new, served, graph_way)
    admission = admission_profiles(torch, wl, "main", params, cfg, prompts)

    solo_div = check_solo(torch, gpt, G, params, cfg, prompts[0], served[0],
                          new)
    logits, _ = G.decode_step(params, G.init_cache(cfg, 1, 8, "cuda"),
                              torch.tensor([prompts[0][0]], device="cuda"),
                              0, cfg)
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    stats = {
        "model": "gpt_1p3b", "params": n_params, "requests": len(served),
        "prompt_lens": lens, "new_tokens": new, "tokens": n_tok,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ticks": len(ticks), "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "peak_mem_gb": peak / 1e9,
        "launches": launches, "tc_launches": tc, "tick_launches": tick,
        "graphs": n_graphs, "solo_generate_equal": solo_div is None,
        "solo_divergence": solo_div, "ways": ways, "admission": admission,
        "device_feed": feed,
    }
    log(f"  tokens/s {stats['tokens_per_s']:.1f}, mean tick "
        f"{stats['tick_ms_mean']:.2f} ms, peak memory "
        f"{stats['peak_mem_gb']:.2f} GB")
    return stats, launches


def paged_path(torch, gpt, G, serving, engine, ks, wl):
    from paddle_tpu_torch.ops.decode_attention import R_TC
    cfg, params, srv, prompts = wl.build_paged_path("cuda", seed=0)
    new, L = wl.NEW, cfg.num_layers
    lens = [len(p) for p in prompts]
    # the contiguous server's tokens on the same prompts (not counted)
    cont = serving.DecodeServer(params, cfg, max_batch=8, max_len=512,
                                device="cuda")
    cont_tokens = serve(torch, cont, prompts, new)[0]
    cont.close()
    del cont
    warm = srv.warmup(prompt_lens=lens)
    replays0 = replays_now(engine, srv)

    chunk_calls = []        # (pos0, length, width C, tc launches added)
    get = engine.ENGINE.get
    dec = ks["paged_decode_attention"]

    def counted_get(kind, spec):
        # each admission chunk call (a graph replay, which counts the
        # launches it captured), read from its feeds
        fn = get(kind, spec)
        if kind != "paged_prefill":
            return fn

        def counted(tokens, pos0, length, slot):
            before = dec.tc_launches
            out = fn(tokens, pos0, length, slot)
            chunk_calls.append((int(pos0), int(length), tokens.shape[1],
                                dec.tc_launches - before))
            return out
        return counted

    engine.ENGINE.get = counted_get
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ks)
        served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
        launches = launch_counts(ks)
        tc = tc_counts(ks)
        tick = tick_counts(ks)
    finally:
        del engine.ENGINE.get
    peak = torch.cuda.max_memory_allocated()
    n_graphs = graphed_serve(torch, engine, srv, ticks, replays0,
                             len(chunk_calls))
    load = srv.load_stats()
    pool = load["kv_pool"]
    n_tok = sum(len(s) for s in served)
    log(f"  served {len(served)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission {t_admit * 1e3:.1f} ms in "
        f"{len(chunk_calls)} chunks {chunk_calls})")
    log(f"  launches in the paged path: {launches}; on tensor-core bodies: "
        f"{tc}")
    for pos0, length, C, added in chunk_calls:
        log(f"  admission chunk pos0={pos0} length={length} C={C}: "
            f"{added} tensor-core paged launches (R_TC={R_TC})")
    log(f"  allocator: {json.dumps(pool)}; prefilled rows "
        f"{load['prefill_rows']} of {sum(lens)} prompt rows")
    if not launches["paged_decode_attention"]:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    # every attention of the path is the block-table kernel's: the pool is
    # read in place, never through a gathered copy and the contiguous one
    assert launches["paged_decode_attention"] == L * (
        len(ticks) + len(chunk_calls)), launches
    assert launches["decode_attention"] == 0, launches
    assert launches["flash_attention_fwd"] == 0, launches
    # every admission at C >= R_TC (G = 1: R = C) on the tensor-core body
    for _, _, C, added in chunk_calls:
        assert added == L * (C >= R_TC), chunk_calls
    assert tc["paged_decode_attention"] == sum(c[3] for c in chunk_calls), tc
    assert tc["decode_attention"] == 0, tc
    # ... and every tick (R = 1), and every admission below R_TC, on the
    # tick body
    narrow = sum(c[2] < R_TC for c in chunk_calls)
    assert tick["paged_decode_attention"] == L * (len(ticks) + narrow), (
        tick, chunk_calls)
    assert tick["decode_attention"] == 0, tick
    assert all(len(s) == new for s in served)
    cont_div = {r: check_tokens(torch, gpt, params, cfg, prompts[r],
                                served[r], cont_tokens[r],
                                f"request {r} vs the contiguous server")
                for r in range(len(prompts))}
    same = sum(len(a) if d is None else d[0]
               for a, d in zip(served, cont_div.values()))
    log(f"  {same} of {n_tok} tokens served before any stream left the "
        f"contiguous server's; requests equal throughout: "
        f"{[r for r, d in cont_div.items() if d is None]}")
    assert served[1] == served[2]           # the same prompt, twice
    assert pool["prefix_hits"] >= 7 * 192, pool
    assert pool["cow_copies"] >= 1 and pool["radix_splits"] >= 1, pool
    assert load["prefill_rows"] < sum(lens), load
    graph_way = way_stats(torch, engine, srv, served, t_admit, ticks, wall,
                          peak, warm)
    srv.close()
    ways = serving_ways(torch, gpt, engine, wl, "paged", cfg, params,
                        prompts, new, served, graph_way)
    admission = admission_profiles(torch, wl, "paged", params, cfg, prompts)
    solo_div = check_solo(torch, gpt, G, params, cfg, prompts[0], served[0],
                          new)
    stats = {
        "model": "gpt_1p3b", "layout": "paged", "block_size": 16,
        "num_blocks": 128, "requests": len(served), "prompt_lens": lens,
        "new_tokens": new, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "ticks": len(ticks),
        "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "admission_chunks": len(chunk_calls),
        "prefill_rows": load["prefill_rows"], "prompt_rows": sum(lens),
        "peak_mem_gb": peak / 1e9, "launches": launches, "tc_launches": tc,
        "tick_launches": tick,
        "admission_chunks_pos0_length_width_tc": chunk_calls, "kv_pool": pool,
        "contiguous_tokens_equal": all(d is None for d in cont_div.values()),
        "tokens_before_divergence": same,
        "contiguous_divergences": {r: d for r, d in cont_div.items()
                                   if d is not None},
        "solo_generate_equal": solo_div is None, "solo_divergence": solo_div,
        "graphs": n_graphs, "ways": ways, "admission": admission,
    }
    log(f"  tokens/s {stats['tokens_per_s']:.1f}, mean tick "
        f"{stats['tick_ms_mean']:.2f} ms, peak memory "
        f"{stats['peak_mem_gb']:.2f} GB")
    return stats, launches


def w4_path(torch, gpt, G, serving, woq, wm, engine, ks, wl):
    """The W4 path (``build_w4_path``): the main path's 8 requests on the
    int4 GPT-1.3B with the W4 kernel, each admission and each tick's W4
    launches counted.  Returns (stats, launches)."""
    from paddle_tpu_torch import telemetry as tl

    cfg, params, srv, prompts = wl.build_w4_path("cuda", seed=0)
    L, new = cfg.num_layers, wl.NEW
    per_pass = 6 * L                # qkv (3 slices) + proj + fc + out
    assert per_pass == 144
    assert woq.is_quantized(params) and params["blocks"]["fc_w"].dtype \
        == torch.int8 and params["blocks"]["fc_w_s"].dim() == 4
    w4_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    bf16_bytes = 2 * gpt.count_params(cfg)
    log(f"  weights on the card: {w4_bytes / 1e9:.3f} GB int4 (group "
        f"{wl.W4_GROUP}, int8 embedding) against {bf16_bytes / 1e9:.3f} GB "
        f"bf16 ({w4_bytes / bf16_bytes:.3f}x)")
    # the bucket rule of DecodeServer._prefill_slot: an admission runs the
    # W4 kernel when its bucket has at most _N_CAP rows
    buckets = [serving._pow2_bucket(n, srv.max_len, cfg.max_seq_len)
               for n in wl.LENS]
    want_admit = [per_pass if b <= wm._N_CAP else 0 for b in buckets]
    w4 = ks["w4_matmul"]
    since = time.time()
    warm = srv.warmup(prompt_lens=wl.LENS)
    replays0 = replays_now(engine, srv)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ks)
    t0 = time.perf_counter()
    rids, admit, admit_tc = [], [], []
    for p in prompts:
        before, before_tc = w4.launches, w4.tc_launches
        rids.append(srv.submit(p, max_new_tokens=new))
        admit.append(w4.launches - before)
        admit_tc.append(w4.tc_launches - before_tc)
    t_admit = time.perf_counter() - t0
    ticks, per_tick, per_tick_tc = [], [], []
    while srv.pending():
        before, before_tc = w4.launches, w4.tc_launches
        t1 = time.perf_counter()
        srv.tick()
        ticks.append(time.perf_counter() - t1)
        per_tick.append(w4.launches - before)
        per_tick_tc.append(w4.tc_launches - before_tc)
        if len(ticks) > 10 * new:
            raise AssertionError("server did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(ks)
    peak = torch.cuda.max_memory_allocated()
    n_graphs = graphed_serve(torch, engine, srv, ticks, replays0,
                             len(prompts))
    served = [srv.result(r) for r in rids]
    n_tok = sum(len(x) for x in served)
    log(f"  served {len(served)} requests, {n_tok} tokens in {wall:.3f} s "
        f"({len(ticks)} ticks; admission prefill {t_admit * 1e3:.1f} ms)")
    log(f"  W4 launches per admission {admit} (buckets {buckets}), per "
        f"tick {sorted(set(per_tick))}; launches in the W4 path: {launches}")
    if admit != want_admit:
        raise AssertionError(f"W4 launches per admission {admit}, not "
                             f"{want_admit}")
    if any(c != per_pass for c in per_tick):
        raise AssertionError(f"W4 launches per tick {per_tick}, not "
                             f"{per_pass} each")
    if admit_tc != want_admit or any(c != per_pass for c in per_tick_tc):
        raise AssertionError(f"W4 tensor-core launches per admission "
                             f"{admit_tc} and per tick "
                             f"{sorted(set(per_tick_tc))}, not {want_admit} "
                             f"and {per_pass}")
    assert launches["w4_matmul"] == per_pass * len(ticks) + sum(want_admit)
    # every W4 launch (bf16 x, gs 64) on the tensor-core body
    tc = tc_counts(ks)
    if tc["w4_matmul"] != launches["w4_matmul"]:
        raise AssertionError(f"{tc['w4_matmul']} of {launches['w4_matmul']} "
                             f"W4 launches on the tensor-core body")
    assert tc == {"flash_attention_fwd": launches["flash_attention_fwd"],
                  "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                  "w4_matmul": launches["w4_matmul"],
                  "decode_attention": 0, "paged_decode_attention": 0}, tc
    assert launches["flash_attention_fwd"] == L * len(prompts), launches
    assert launches["decode_attention"] == L * len(ticks), launches
    assert launches["fused_layer_norm_fwd"] == 0, launches
    tick = tick_counts(ks)
    if tick["decode_attention"] != launches["decode_attention"]:
        raise AssertionError(f"{tick['decode_attention']} of "
                             f"{launches['decode_attention']} W4-path tick "
                             f"launches on the tick body")
    assert all(len(x) == new and all(0 <= t < cfg.vocab_size for t in x)
               for x in served)
    feed = feed_gates(tl, cfg, "W4 graph serve", since)
    graph_way = way_stats(torch, engine, srv, served, t_admit, ticks, wall,
                          peak, warm)
    srv.close()
    ways = serving_ways(torch, gpt, engine, wl, "w4", cfg, params, prompts,
                        new, served, graph_way)
    admission = admission_profiles(torch, wl, "w4", params, cfg, prompts)
    # the reference: the same int4 weights through the dequantizing route
    os.environ["PADDLE_TPU_W4_KERNEL"] = "0"
    solo_div = {r: check_solo(torch, gpt, G, params, cfg, prompts[r],
                              served[r], new) for r in (0, 3)}
    os.environ.pop("PADDLE_TPU_W4_KERNEL", None)
    stats = {
        "model": "gpt_1p3b int4 (quantize_gpt_int4, group 64)",
        "weight_bytes": w4_bytes, "bf16_weight_bytes": bf16_bytes,
        "requests": len(served), "prompt_lens": wl.LENS, "new_tokens": new,
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ticks": len(ticks), "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "tick_ms_median": 1e3 * statistics.median(ticks),
        "admission_ms": 1e3 * t_admit, "peak_mem_gb": peak / 1e9,
        "w4_per_tick": per_pass, "w4_per_admission": admit,
        "w4_tc_per_admission": admit_tc,
        "launches": launches, "tc_launches": tc, "tick_launches": tick,
        "graphs": n_graphs, "ways": ways, "admission": admission,
        "dequant_route_equal": {r: d is None for r, d in solo_div.items()},
        "dequant_route_divergence": {r: d for r, d in solo_div.items()
                                     if d is not None},
        "device_feed": feed,
    }
    log(f"  tokens/s {stats['tokens_per_s']:.1f}, mean tick "
        f"{stats['tick_ms_mean']:.2f} ms, peak memory "
        f"{stats['peak_mem_gb']:.2f} GB")
    return stats, launches


def staggered_serve(torch, srv, prompts, new, first=4, every=8):
    """The first ``first`` prompts at once, then one more every ``every``
    ticks, ``tick()`` until drained.  Returns (tokens per request, wall of
    each loop iteration — its submit and its tick, the gap the decoding
    slots see —, whether a slot was admitting at each tick, wall
    seconds)."""
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts[:first]]
    waiting = list(prompts[first:])
    walls, admitting = [], []
    while srv.pending() or waiting:
        t1 = time.perf_counter()
        if waiting and len(walls) % every == every - 1:
            rids.append(srv.submit(waiting.pop(0), max_new_tokens=new))
        admitting.append(any(st.get("admitting")
                             for st in srv._slots.values()))
        srv.tick()
        walls.append(time.perf_counter() - t1)
        if len(walls) > 20 * new:
            raise AssertionError("server did not drain")
    torch.cuda.synchronize()
    return ([srv.result(r) for r in rids], walls, admitting,
            time.perf_counter() - t0)


BUDGET = 64     # the budgeted serve's prefill budget, tokens a round


def budgeted_path(torch, gpt, engine, wl):
    """The main path's 8 requests arriving over time (4 at once, then one
    every 8 ticks), served by two fresh graphed servers of its geometry,
    warmed up: monolithic admission, and ``prefill_budget=BUDGET``.
    Gated: every budgeted stream equal to the monolithic one by the tie
    rule, each prompt longer than the budget claimed, at least one chunk
    interleaved, and every chunk one replay of the budget-width graph.
    Reported: each serve's tokens/s, the longest loop iteration (the
    decoding slots' longest stall) of the monolithic serve against the
    budgeted serve's longest tick while a slot was admitting."""
    cfg, params, mono, prompts = wl.build_main_path("cuda", seed=0)
    lens = [len(p) for p in prompts]
    runs = {}
    for name in ("monolithic", "budgeted"):
        srv = mono if name == "monolithic" else wl.make_server(
            "main", params, cfg, prefill_budget=BUDGET)
        warm = srv.warmup(prompt_lens=lens)
        replays0 = replays_now(engine, srv)
        torch.cuda.synchronize()
        served, walls, admitting, wall = staggered_serve(torch, srv,
                                                         prompts, wl.NEW)
        n_tok = sum(len(x) for x in served)
        adm_walls = [w for w, a in zip(walls, admitting) if a]
        adm_replays = admission_replays(engine, srv) - replays0[1]
        # device ms of one admission replay: the budget-width chunk, or
        # the bucket of the longest prompt (300 tokens at 512)
        if name == "budgeted":
            fn = engine.ENGINE.get("prefill_chunk", srv._spec(width=BUDGET))
            feeds = srv._feeds(prompts[3][:BUDGET], BUDGET, 0, BUDGET, 0)
        else:
            fn = engine.ENGINE.get("prefill", srv._spec(bucket=512))
            feeds = srv._feeds(prompts[3], 512, len(prompts[3]), 0)
        replay_ms = event_ms(torch, lambda: fn(*feeds))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(*feeds)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        replay_families = wl.summarize(torch, prof, t_prof, 1)[
            "device_ms_by_family"]
        runs[name] = {
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ticks": len(walls), "warmup_s": sum(warm.values()),
            "longest_iteration_ms": 1e3 * max(walls),
            "median_iteration_ms": 1e3 * statistics.median(walls),
            "admitting_ticks": len(adm_walls),
            "longest_admitting_tick_ms": (1e3 * max(adm_walls)
                                          if adm_walls else None),
            "admitting_ticks_ms": [round(1e3 * w, 3) for w in adm_walls],
            "iterations_ms": [round(1e3 * w, 3) for w in walls[:40]],
            "admission_replay_device_ms": replay_ms,
            "admission_replay_by_family": replay_families,
            **srv.stats(),
            "admission_replays": adm_replays,
            "streams": served}
        srv.close()
    b, m = runs["budgeted"], runs["monolithic"]
    long = sum(n > BUDGET for n in lens)
    div = {r: check_tokens(torch, gpt, params, cfg, prompts[r],
                           b["streams"][r], m["streams"][r],
                           f"budgeted request {r} vs monolithic")
           for r in range(len(prompts))}
    for run in runs.values():
        run.pop("streams")
    log(f"  monolithic: tokens/s {m['tokens_per_s']:.1f}, longest loop "
        f"iteration {m['longest_iteration_ms']:.2f} ms (median "
        f"{m['median_iteration_ms']:.2f}), a 300-token admission replay "
        f"{m['admission_replay_device_ms']:.3f} ms of device; budgeted "
        f"{BUDGET}: tokens/s {b['tokens_per_s']:.1f}, longest tick while "
        f"admitting {b['longest_admitting_tick_ms']:.2f} ms of "
        f"{b['admitting_ticks']} admitting ticks (median "
        f"{statistics.median(b['admitting_ticks_ms']):.2f}), longest "
        f"iteration {b['longest_iteration_ms']:.2f} ms, a {BUDGET}-token "
        f"chunk replay {b['admission_replay_device_ms']:.3f} ms of device "
        f"(by family, profiled: {b['admission_replay_by_family']}; the "
        f"slot's copy is cache_gather)")
    log(f"  monolithic iterations (ms): {m['iterations_ms']}")
    log(f"  budgeted iterations (ms): {b['iterations_ms']}; admitting "
        f"ticks: {b['admitting_ticks_ms']}")
    if b["serving.admitting_claims"] != long \
            or b["serving.prefill_chunks_interleaved"] < 1:
        raise AssertionError(f"budgeted serve: {b}")
    # every chunk one replay; the short prompts' bucket admissions too
    if b["admission_replays"] != (b["serving.prefill_chunks_interleaved"]
                                  + len(lens) - long):
        raise AssertionError(f"budgeted serve's admission replays: {b}")
    return {"budget": BUDGET, "arrivals": "4 at once, then one every 8 "
            "ticks", **runs,
            "streams_equal": all(d is None for d in div.values()),
            "divergences": {r: d for r, d in div.items() if d is not None}}


def event_ms(torch, fn, iters=10):
    """Device ms of one ``fn()`` (a graph replay with its feed copies),
    CUDA events around ``iters`` back-to-back calls after one more."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def generate_path(torch, gpt, G, serving, engine):
    """Greedy ``generate.generate`` on GPT-1.3B (the main path's weights):
    batch 8, one 64-token prompt each, 32 new tokens — gated equal by the
    tie rule to a ``DecodeServer`` (main geometry, graphed) serving the
    same prompts, every position one replay of the captured step (the
    first call captures it)."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 64))
    new, P = 32, 64

    def replays():
        return sum(g.replays for g in engine.ENGINE.graphs()
                   if g.name == "generate.generate")

    walls = []
    for _ in range(2):          # the first call captures the step
        r0 = replays()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G.generate(params, cfg, prompts, new, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if replays() - r0 != P + new - 1:
            raise AssertionError(f"generate replayed its step "
                                 f"{replays() - r0} times, not "
                                 f"{P + new - 1}")
    srv = serving.DecodeServer(params, cfg, max_batch=8, max_len=512,
                               device="cuda")
    ref = serve(torch, srv, prompts.tolist(), new)[0]
    srv.close()
    got = out[:, P:].tolist()
    div = {r: check_tokens(torch, gpt, params, cfg, prompts[r].tolist(),
                           got[r], ref[r], f"generate row {r} vs the server")
           for r in range(len(got))}
    engine.ENGINE.purge(cfg)
    stats = {"batch": 8, "prompt": P, "new_tokens": new,
             "replays_per_call": P + new - 1, "first_call_s": walls[0],
             "second_call_s": walls[1],
             "tokens_per_s": 8 * new / walls[1],
             "server_equal": all(d is None for d in div.values()),
             "divergences": {r: d for r, d in div.items() if d is not None}}
    log(f"  generate: {P + new - 1} replays a call; first call "
        f"{walls[0]:.3f} s (capture), second {walls[1]:.3f} s "
        f"({stats['tokens_per_s']:.1f} tokens/s); rows equal to the "
        f"server's: {stats['server_equal']} {stats['divergences']}")
    return stats


# ---------------------------------------------------------------------------
# speculation and beam search on GPT-1.3B
# ---------------------------------------------------------------------------

# the small drafter of the JAX bench's speculation arm: the target's
# vocabulary, hidden 512, 4 layers, 8 heads, random weights from seed 1
SMALL_DRAFT = dict(vocab_size=50304, hidden_size=512, num_layers=4,
                   num_heads=8)


def _small_server(serving, cfg, params, dev, layout, **kw):
    """A server of the small card-vs-CPU models: max_batch 4, the paged
    one with its blocks handed out in a shuffled order on the card."""
    lay = (dict(layout="paged", block_size=16, num_blocks=48)
           if layout == "paged" else {})
    srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                               device=dev, **lay, **kw)
    if layout == "paged" and dev == "cuda":
        srv._pool._free = np.random.default_rng(0).permutation(
            srv._pool.N).tolist()
    return srv


def _biased(params, scale=30.0, row=42):
    """The JAX bench's biased draft (bench.py's tree arm): the target's
    weights with the final LayerNorm bias pushed toward embedding row
    ``row``, so its argmax is wrong nearly everywhere and the truth often
    sits at its second choice — a tree's sibling branch."""
    bad = dict(params)
    bad["ln_f_b"] = params["ln_f_b"] + scale * params["wte"][row]
    return bad


def _random_trees(rng, G, B, N):
    """Random trees of 2..N nodes a slot, padded with self-only rows at
    depth 0: (ancestor mask [B, N, N] bool, depths [B, N] int64) as numpy
    arrays."""
    amask = np.zeros((B, N, N), bool)
    amask[:, np.arange(N), np.arange(N)] = True
    depth = np.zeros((B, N), np.int64)
    for b in range(B):
        n = int(rng.integers(2, N + 1))
        parent = [-1] + [int(rng.integers(0, j)) for j in range(1, n)]
        amask[b, :n, :n] = G.tree_ancestor_mask(parent)
        depth[b, :n] = G.tree_depths(parent)
    return amask, depth


def spec_small_vs_cpu(torch, gpt, G, serving):
    """Small fp32 models (fp32 and int8 KV), contiguous and paged: the
    batched verify's logits at K = SPEC_K on the card (the decode kernels'
    tick body, R = K * G) and the tree verify's at N = SPEC_K over random
    trees (the einsum under the tree mask) against the CPU's plain math
    from the same admitted prompts, within PATH_TOL; and graphed
    speculating servers on the card — linear with draft == target, tree
    with draft == target and with the biased draft (its paths leave the
    trunk, so the rows move) — against the plain server on the CPU:
    exactly the same greedy streams.  Returns the largest logit gaps,
    linear and tree."""
    worst = tworst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        cpu = gpt.init_params(cfg, seed=11, device="cpu")
        card = _to_card(cpu)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (7, 60, 100)]
        for layout in ("contiguous", "paged"):
            logits, tlogits = {}, {}
            toks = rng.integers(0, cfg.vocab_size, (4, SPEC_K))
            amask, depth = (torch.from_numpy(a) for a in
                            _random_trees(rng, G, 4, SPEC_K))
            for dev, p in (("cpu", cpu), ("cuda", card)):
                srv = _small_server(serving, cfg, p, dev, layout)
                for pr in prompts:
                    srv.submit(pr, max_new_tokens=8)
                srv._ensure_decode_blocks(SPEC_K)
                feed, pos = srv._feed_arrays()
                toks[:, 0] = feed
                # live slots only: a free paged slot reads exact zeros
                # through the kernel and block 0 through the plain gather
                live = sorted(srv._slots)
                logits[dev] = serving.spec_verify_batched(
                    p, srv.cache, torch.from_numpy(toks).to(dev),
                    torch.from_numpy(pos).to(dev), cfg)[0][live].cpu()
                tlogits[dev] = serving.spec_tree_verify_batched(
                    p, srv.cache, torch.from_numpy(toks).to(dev),
                    amask.to(dev), depth.to(dev),
                    torch.from_numpy(pos).to(dev), cfg)[0][live].cpu()
                srv.close()
            worst = max(worst, (logits["cuda"] - logits["cpu"]).abs().max()
                        .item())
            tworst = max(tworst, (tlogits["cuda"] - tlogits["cpu"]).abs()
                         .max().item())
            ref = serve(torch, _small_server(serving, cfg, cpu, "cpu",
                                             layout), prompts, 12)[0]
            srv = _small_server(serving, cfg, card, "cuda", layout,
                                spec_k=SPEC_K, draft_cfg=cfg,
                                draft_params=card)
            got = serve(torch, srv, prompts, 12)[0]
            rounds = srv._spec_rounds
            srv.close()
            if got != ref:
                raise AssertionError(f"{name} kv={kv or 'fp32'} {layout}: "
                                     f"spec streams on the card {got} differ "
                                     f"from plain on the CPU {ref}")
            if not rounds:
                raise AssertionError(f"{name} {layout}: no verify round")
            for dname, dp in (("draft==target", card),
                              ("biased", _biased(card))):
                srv = _small_server(serving, cfg, card, "cuda", layout,
                                    spec_tree=SPEC_K, draft_cfg=cfg,
                                    draft_params=dp)
                got = serve(torch, srv, prompts, 12)[0]
                rounds = srv._spec_rounds
                srv.close()
                if got != ref:
                    raise AssertionError(
                        f"{name} kv={kv or 'fp32'} {layout} tree {dname}: "
                        f"streams on the card {got} differ from plain on "
                        f"the CPU {ref}")
                if not rounds:
                    raise AssertionError(f"{name} {layout} tree {dname}: "
                                         f"no verify round")
        log(f"  {name} kv={kv or 'fp32'}: max|verify logits card - cpu| so "
            f"far {worst:.3g}, tree verify {tworst:.3g} (tol {PATH_TOL}); "
            f"linear and tree spec streams on the card equal plain on the "
            f"CPU, both layouts")
        if not (worst <= PATH_TOL and tworst <= PATH_TOL):
            raise AssertionError(f"verify on the card disagrees with the CPU "
                                 f"on {name}")
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    return worst, tworst


def _binds(srv):
    return [b for b in (srv._bind, srv._draft_bind) if b is not None]


def _replays(engine, srv):
    """{(binding index, graph name): replays} of ``srv``'s graphs, the
    draft's under index 1."""
    return {(i, g.name): g.replays for i, b in enumerate(_binds(srv))
            for g in engine.ENGINE.graphs(b)}


def spec_arm(torch, engine, wl, tl, ks, path, cfg, params, prompts, new,
             name, sub=None, **kw):
    """One graphed serve of ``path``'s geometry (main: contiguous; paged:
    full provisioning) with ``kw``'s server options, warmed up first:
    streams, and stats — tokens/s, target passes (verify rounds + plain
    ticks) a generated token, acceptance, fallbacks, draft steps, the
    replays of each graph and the kernel launches during the serve, the
    graphs captured and builds recorded after the warmup."""
    if path == "paged":
        kw["num_blocks"] = None             # a block for every row
    gc.collect()
    torch.cuda.empty_cache()
    srv = wl.make_server(path, params, cfg, **kw)
    warm = srv.warmup(prompt_lens=[len(p) for p in prompts])
    rep0 = _replays(engine, srv)
    builds0 = len(tl.compile_log())
    torch.cuda.synchronize()
    zero_counts(ks)
    served, t_admit, ticks, wall = serve(torch, srv, prompts, new,
                                         **(sub or {}))
    launches, tick, tc = launch_counts(ks), tick_counts(ks), tc_counts(ks)
    rep = {k: v - rep0.get(k, 0) for k, v in _replays(engine, srv).items()}
    n_tok = sum(len(s) for s in served)
    spec = srv._spec_on
    passes = (srv._spec_rounds + srv._spec_plain_steps) if spec \
        else srv._step_no
    counts = srv.stats()
    N = srv._spec_tree_n
    vname = (f"serving.spec_tree_verify@{N}" if N
             else f"serving.spec_verify@{srv._spec_k}")
    cname = f"serving.spec_tree_commit@{N}"
    verify = rep.get((0, vname), 0) if spec else 0
    stats = {
        "arm": name, "path": path, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "ticks": len(ticks),
        "tick_ms_mean": 1e3 * statistics.mean(ticks),
        "target_passes": passes, "passes_per_token": passes / n_tok,
        "verify_rounds": srv._spec_rounds if spec else 0,
        "plain_steps": srv._spec_plain_steps if spec else srv._step_no,
        "accept_rate": srv.load_stats()["spec_accept_rate"],
        "fallbacks": counts.get("spec.fallbacks", 0),
        "reearns": counts.get("spec.reearns", 0),
        "draft_steps": counts.get("spec.draft_steps", 0),
        "verify_replays": verify, "tree": N,
        "commit_replays": rep.get((0, cname), 0),
        "tree_accept_len": srv.load_stats()["spec_tree_accept_len"],
        "replays": {f"{'draft ' if i else ''}{n}": v
                    for (i, n), v in sorted(rep.items()) if v},
        "launches": launches, "tick_launches": tick, "tc_launches": tc,
        "captures_after_warmup": sorted(
            f"{i}:{n}" for i, n in set(_replays(engine, srv)) - set(rep0)),
        "builds_after_warmup": len(tl.compile_log()) - builds0,
        "warmup_s": sum(warm.values()),
    }
    # device ms of one replay of each graph a round runs (its last feeds
    # again: the rows it rewrites are its own)
    graphs = {(i, g.name): g for i, b in enumerate(_binds(srv))
              for g in engine.ENGINE.graphs(b)}
    stats["graph_ms"] = {
        f"{'draft ' if i else ''}{n}": event_ms(torch, lambda g=g: g(
            *g.static)) for (i, n), g in sorted(graphs.items())
        if n in ("serving.step", vname, cname,
                 f"serving.block@{srv._spec_k - 1}")}
    if spec:
        # what one verify replay launches of each decode wrapper, as its
        # capture recorded it
        g = graphs[(0, vname)]
        stats["verify_delta"] = {
            f"{w.__name__}.{a}": d for (w, a), d in g.delta.items()
            if d and w.__name__.endswith("decode_attention")}
    srv.close()
    log(f"  {name} ({path}): tokens/s {stats['tokens_per_s']:.1f}, "
        f"{passes} target passes ({stats['passes_per_token']:.4f} a token: "
        f"{stats['verify_rounds']} verify rounds + {stats['plain_steps']} "
        f"plain steps), accept rate {stats['accept_rate']}, fallbacks "
        f"{stats['fallbacks']}, draft steps {stats['draft_steps']}"
        + (f", mean accepted path {stats['tree_accept_len']}" if N else "")
        + f", mean call {stats['tick_ms_mean']:.2f} ms; replays "
        f"{stats['replays']}; "
        f"device ms a replay {stats['graph_ms']}")
    return served, stats


def spec_gates(torch, gpt, cfg, params, prompts, plain, arm, served):
    """The draft == target arm's gates: streams equal the plain server's
    by the tie rule, and every token of every speculative stream (the
    plain ones too, as the control) within TIE_TOL of the best logit of a
    teacher-forced forward over its own prompt + stream, so a verify
    fault after an early tie still shows; at least 1.5x fewer target
    passes a token; every
    verify one replay of ``spec_verify@K`` (a tree arm: ``spec_tree_verify
    @N``) and no capture or build after the warmup; each linear verify
    replay one launch of the layout's decode kernel a layer on its tick
    body (a tree verify none: its attention is the einsum under the tree
    mask), and every decode launch of the serve on the tick body: L x
    (linear verifies + plain steps + the draft's steps)."""
    L = cfg.num_layers
    div = {r: check_tokens(torch, gpt, params, cfg, prompts[r], served[r],
                           plain[0][r], f"{arm['arm']} {arm['path']} request "
                           f"{r} vs plain") for r in range(len(prompts))}
    arm["plain_equal"] = all(d is None for d in div.values())
    arm["plain_divergences"] = {r: d for r, d in div.items() if d is not None}
    for key, streams in (("forced_gap", served),
                         ("plain_forced_gap", plain[0])):
        arm[key] = max(forced_gap(torch, gpt, params, cfg, prompts[r],
                                  streams[r]) for r in range(len(prompts)))
    if not (arm["forced_gap"] <= TIE_TOL and arm["plain_forced_gap"]
            <= TIE_TOL):
        raise AssertionError(f"{arm['arm']} {arm['path']}: a served token "
                             f"{arm['forced_gap']} (plain "
                             f"{arm['plain_forced_gap']}) under the best "
                             f"teacher-forced logit (tol {TIE_TOL})")
    ratio = plain[1]["passes_per_token"] / arm["passes_per_token"]
    arm["passes_ratio_vs_plain"] = ratio
    if ratio < 1.5:
        raise AssertionError(f"{arm['arm']}: target passes a token only "
                             f"{ratio:.3f}x fewer than plain")
    if arm["verify_replays"] != arm["verify_rounds"] or \
            arm["captures_after_warmup"] or arm["builds_after_warmup"]:
        raise AssertionError(f"{arm['arm']}: {arm['verify_rounds']} rounds, "
                             f"{arm['verify_replays']} verify replays, "
                             f"captures after warmup "
                             f"{arm['captures_after_warmup']}, builds "
                             f"{arm['builds_after_warmup']}")
    wrap = ("paged_decode_attention" if arm["path"] == "paged"
            else "decode_attention")
    tree = bool(arm["tree"])
    if arm["verify_delta"] != ({} if tree else {f"{wrap}.launches": L,
                                                f"{wrap}.tick_launches": L}):
        raise AssertionError(f"a verify replay launches "
                             f"{arm['verify_delta']}")
    rp = arm["replays"]
    draft = (SPEC_K - 1) * rp.get(f"draft serving.block@{SPEC_K - 1}", 0) \
        + rp.get("draft serving.step", 0)
    want = L * (0 if tree else arm["verify_replays"]) \
        + L * (rp.get("serving.step", 0) + draft)
    arm["draft_decode_launches"] = L * draft
    if not arm["tick_launches"][wrap] == want:
        raise AssertionError(f"{arm['tick_launches'][wrap]} tick launches "
                             f"of {wrap}, not {want}")
    if arm["path"] == "main" and arm["launches"][wrap] != want:
        raise AssertionError(f"{arm['launches'][wrap]} launches of {wrap}")
    log(f"  gates: {arm['arm']} {arm['path']} streams equal to plain "
        f"{arm['plain_equal']} {arm['plain_divergences']}; every token "
        f"within {arm['forced_gap']:.4g} of the teacher-forced best (plain "
        f"streams {arm['plain_forced_gap']:.4g}, tol {TIE_TOL}); passes "
        f"{ratio:.3f}x fewer; {arm['verify_replays']} verify replays, one a "
        f"round, each "
        + ("no decode launch (the tree mask's einsum); "
           f"{arm['commit_replays']} commit replays" if tree else
           f"{L} tick-body launches of {wrap}")
        + f"; the draft's own steps launched "
        f"{arm['draft_decode_launches']} more")


def spec_phase(torch, gpt, G, serving, engine, ks, wl):
    """[speculation: GPT-1.3B, K = SPEC_K] — the small models first
    (:func:`spec_small_vs_cpu`), then the main path's model and 8
    requests, graphed: plain, draft == target linear and tree (N = SPEC_K,
    branch 2; gated, contiguous and paged: :func:`spec_gates`), the
    bench's small drafter, n-gram self-drafting (linear and tree) on
    prompts whose second half repeats the first, the bench's biased draft
    tree against linear (reported), and sampled serves at temperature 1,
    draft == target linear and tree, beside a plain sampled serve of the
    same requests (each must finish every request)."""
    from paddle_tpu_torch import telemetry as tl

    vgap, tgap = spec_small_vs_cpu(torch, gpt, G, serving)
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    prompts, new = wl.main_prompts(cfg.vocab_size, 0), wl.NEW
    both = dict(spec_k=SPEC_K, draft_cfg=cfg, draft_params=params)
    tree = dict(spec_tree=SPEC_K, draft_cfg=cfg, draft_params=params)
    arms, launches, gated = {}, {}, []
    for path in ("main", "paged"):
        plain = spec_arm(torch, engine, wl, tl, ks, path, cfg, params,
                         prompts, new, "plain")
        arms[f"{path} plain"] = plain[1]
        for name, kw in (("draft==target", both),
                         ("tree draft==target", tree)):
            served, arm = spec_arm(torch, engine, wl, tl, ks, path, cfg,
                                   params, prompts, new, name, **kw)
            spec_gates(torch, gpt, cfg, params, prompts, plain, arm, served)
            arms[f"{path} {name}"] = arm
            gated.append(arm)
            for n, v in arm["launches"].items():
                launches[n] = launches.get(n, 0) + v
    biased = _biased(params)
    for name, kw in (("biased draft", dict(spec_k=SPEC_K)),
                     ("tree biased draft", dict(spec_tree=SPEC_K))):
        arms[f"main {name}"] = spec_arm(
            torch, engine, wl, tl, ks, "main", cfg, params, prompts, new,
            name, draft_cfg=cfg, draft_params=biased, **kw)[1]
    del biased
    dcfg = gpt.GPTConfig(**SMALL_DRAFT)
    dparams = gpt.init_params(dcfg, seed=1, device="cuda")
    arms["main small draft"] = spec_arm(
        torch, engine, wl, tl, ks, "main", cfg, params, prompts, new,
        "small draft", spec_k=SPEC_K, draft_cfg=dcfg,
        draft_params=dparams)[1]
    del dparams
    halves = [p[:len(p) // 2] * 2 for p in prompts]
    arms["main n-gram plain"] = spec_arm(torch, engine, wl, tl, ks, "main",
                                         cfg, params, halves, new,
                                         "plain (repeated halves)")[1]
    arms["main n-gram"] = spec_arm(torch, engine, wl, tl, ks, "main", cfg,
                                   params, halves, new, "n-gram",
                                   spec_k=SPEC_K)[1]
    arms["main tree n-gram"] = spec_arm(torch, engine, wl, tl, ks, "main",
                                        cfg, params, halves, new,
                                        "tree n-gram", spec_tree=SPEC_K)[1]
    hot = dict(temperature=1.0)
    arms["main sampled plain"] = spec_arm(torch, engine, wl, tl, ks, "main",
                                          cfg, params, prompts, new,
                                          "plain sampled, temperature 1",
                                          sub=hot)[1]
    arms["main sampled"] = spec_arm(torch, engine, wl, tl, ks, "main", cfg,
                                    params, prompts, new,
                                    "draft==target sampled, temperature 1",
                                    sub=hot, **both)[1]
    t_tree = time.perf_counter()
    arms["main sampled tree"] = spec_arm(
        torch, engine, wl, tl, ks, "main", cfg, params, prompts, new,
        "tree draft==target sampled, temperature 1", sub=hot, **tree)[1]
    t_tree = time.perf_counter() - t_tree
    for name in ("main sampled", "main sampled tree"):
        if arms[name]["tokens"] != len(prompts) * new:
            raise AssertionError(f"the {name} serve did not finish")
    stats = {"k": SPEC_K, "tree_nodes": SPEC_K, "tree_branch": 2,
             "sampled_tree_s": t_tree, "verify_logit_gap_small": vgap,
             "tree_verify_logit_gap_small": tgap,
             "small_streams_equal": True,
             "arms": {n: {k: v for k, v in a.items()
                          if k not in ("launches", "tc_launches")}
                      for n, a in arms.items()}}
    # the gated arms' launches count for the kernels line
    tick = {n: sum(a["tick_launches"][n] for a in gated)
            for n in ("decode_attention", "paged_decode_attention")}
    tc = {n: sum(a["tc_launches"][n] for a in gated)
          for n in gated[0]["tc_launches"]}
    stats.update(tick_launches=tick, tc_launches=tc)
    engine.ENGINE.purge(cfg, dcfg)
    return stats, launches


def beam_phase(torch, gpt, G, engine, ks):
    """[beam search: GPT-1.3B, 2 prompts x 64 tokens, num_beams 4, 32
    new] — small fp32 models first: the card's tokens exactly the CPU's,
    scores within 1e-4; then GPT-1.3B (the main path's weights): one beam
    equals greedy ``generate`` by the tie rule, and width 4 replays the
    ``beam`` graph once a position (the prompt positions replay
    ``generate``'s step at batch B * W), with its call wall, the beam
    graph's device ms and the cache reorder's device ms apart (it copies
    the whole [L, B * W, T, ...] cache each position: bound 4 x its bytes,
    read and written twice)."""
    worst = 0.0
    for name, cfg, kv in _small_models(torch, gpt):
        if kv:
            continue
        cpu = gpt.init_params(cfg, seed=13, device="cpu")
        card = _to_card(cpu)
        prompts = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                    (2, 9))
        want_t, want_s = G.beam_search(cpu, cfg, prompts, 8, num_beams=4,
                                       device="cpu")
        got_t, got_s = G.beam_search(card, cfg, prompts, 8, num_beams=4,
                                     device="cuda")
        gap = (got_s.cpu() - want_s).abs().max().item()
        worst = max(worst, gap)
        log(f"  {name}: beam tokens card == cpu "
            f"{got_t.cpu().tolist() == want_t.tolist()}, max|score gap| "
            f"{gap:.3g} (tol 1e-4)")
        if got_t.cpu().tolist() != want_t.tolist() or not gap <= 1e-4:
            raise AssertionError(f"beam search on the card disagrees with "
                                 f"the CPU on {name}")
        engine.ENGINE.purge(cfg)
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    B, P, new, W = 2, 64, 32, 4
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, P))
    greedy = G.generate(params, cfg, prompts, new, device="cuda")
    one, _ = G.beam_search(params, cfg, prompts, new, num_beams=1,
                           device="cuda")
    div = {r: check_tokens(torch, gpt, params, cfg, prompts[r].tolist(),
                           one[r, P:].tolist(), greedy[r, P:].tolist(),
                           f"beam 1 row {r} vs greedy") for r in range(B)}

    def graph(name):
        bind = engine.ENGINE.generate_binding(params, cfg, B * W, P + new,
                                              torch.device("cuda", 0))
        return [g for g in engine.ENGINE.graphs(bind) if g.name == name]

    walls, launches = [], None
    for i in range(2):              # the first call captures both steps
        r0 = sum(g.replays for g in graph("generate.beam_search"))
        torch.cuda.synchronize()
        if i:
            zero_counts(ks)
        t0 = time.perf_counter()
        toks, scores = G.beam_search(params, cfg, prompts, new, num_beams=W,
                                     device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i:
            launches, tick = launch_counts(ks), tick_counts(ks)
            tc = tc_counts(ks)
        replays = sum(g.replays for g in graph("generate.beam_search")) - r0
        if replays != new:
            raise AssertionError(f"beam search replayed its step {replays} "
                                 f"times, not {new}")
    assert toks.shape == (B, P + new) and bool(torch.isfinite(scores).all())
    L, steps = cfg.num_layers, P - 1 + new
    if not launches["decode_attention"] == tick["decode_attention"] \
            == L * steps:
        raise AssertionError(f"beam search launched {launches} ({tick} on "
                             f"the tick body), not {L * steps} a call")
    (g,) = graph("generate.beam_search")
    (feed,) = graph("generate.generate")
    cache = g.binding.cache
    flat = torch.arange(B * W, device=cache["k"].device)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    reorder_ms = event_ms(torch, lambda: [t.copy_(t.index_select(1, flat))
                                          for t in cache.values()])
    stats = {"batch": B, "prompt": P, "new_tokens": new, "num_beams": W,
             "beam1_equals_greedy": all(d is None for d in div.values()),
             "beam1_divergences": {r: d for r, d in div.items()
                                   if d is not None},
             "small_score_gap": worst, "first_call_s": walls[0],
             "second_call_s": walls[1], "positions": steps,
             "wall_ms_a_position": 1e3 * walls[1] / steps,
             "beam_graph_ms": event_ms(torch, lambda: g(*g.static)),
             "prompt_step_ms": event_ms(torch, lambda: feed(*feed.static)),
             "reorder_ms": reorder_ms, "cache_gb": cache_bytes / 1e9,
             "reorder_bound_ms": 4 * cache_bytes / HBM_BYTES_PER_S * 1e3,
             "launches_a_call": launches["decode_attention"],
             "tick_launches": tick, "tc_launches": tc,
             "scores": scores.tolist()}
    engine.ENGINE.purge(cfg)
    log(f"  beam 1 == greedy {stats['beam1_equals_greedy']} "
        f"{stats['beam1_divergences']}; width {W}: {new} beam replays a "
        f"call, call {walls[1]:.3f} s ({stats['wall_ms_a_position']:.3f} ms "
        f"a position over {steps}; first call {walls[0]:.3f} s captures), "
        f"beam graph {stats['beam_graph_ms']:.3f} ms, prompt step "
        f"{stats['prompt_step_ms']:.3f} ms, cache reorder "
        f"{reorder_ms:.4f} ms ({stats['cache_gb']:.3f} GB cache, bound "
        f"{stats['reorder_bound_ms']:.4f} ms)")
    return stats, launches


# ---------------------------------------------------------------------------
# the pressure phase: the spill tier and its restores, the OOM ladder (a
# half-prefilled slot too), TTL shedding, the NaN guard, the wedge
# watchdog and a real OOM, on GPT-1.3B
# ---------------------------------------------------------------------------

# device time by family in a pressure profile: the restore's copies and
# scatter first, then the serving families
PRESSURE_FAMILIES = (("memcpy_htod", ("memcpy htod",)),
                     ("memcpy_dtoh", ("memcpy dtoh",)),
                     ("memcpy_dtod", ("memcpy dtod",)),
                     ("memset", ("memset",)),
                     ("inject_scatter", ("index_copy",)))


def restore_runs(recs, bs):
    """The inject calls ``_drain_restores`` makes for restore records
    ``recs``: per slot, one a run of contiguous blocks."""
    runs = 0
    by_slot = {}
    for slot, start, _rows, _b in recs:
        by_slot.setdefault(slot, []).append(start)
    for starts in by_slot.values():
        starts.sort()
        runs += 1 + sum(b != a + bs for a, b in zip(starts, starts[1:]))
    return runs


def pressure_serve(torch, engine, wl, cfg, params, waves, name, spill_mb,
                   num_blocks=None):
    """One paged server of the pressure phase (the paged path's geometry;
    ``num_blocks`` overrides the pool size, ``spill_mb`` sets
    ``PADDLE_TPU_KV_SPILL_MB`` for its construction) serving ``waves``
    (``profile_serving.serve_waves``), warmed up first at every prompt's
    admission widths and, with the spill tier, at the inject width the
    returning chain needs.  Records each spill fetch's and each restore's
    wall (synchronized), the restore records, every admission chunk's
    width, and profiles the last wave's admissions.  Returns a dict."""
    from torch.profiler import ProfilerActivity, profile

    os.environ["PADDLE_TPU_KV_SPILL_MB"] = str(spill_mb)
    t0 = time.perf_counter()
    try:
        srv = wl.make_server("paged", params, cfg,
                             **({"num_blocks": num_blocks}
                                if num_blocks else {}))
    finally:
        del os.environ["PADDLE_TPU_KV_SPILL_MB"]
    build_s = time.perf_counter() - t0     # the spill tier's pinning
    srv.warmup(prompt_lens=sorted({len(p) for w in waves for p in w}))
    inject_bucket = 256                  # the 12-block chain: rows [0, 192)
    if spill_mb:
        # capture the inject graph before the serve, writing nowhere (no
        # table names the sink), so the profiled restore is a replay
        rows = [torch.zeros((t.shape[0], 1, inject_bucket)
                            + tuple(t.shape[3:]), dtype=t.dtype,
                            device=srv.device)
                for n, t in srv.cache.items() if n != "tables"]
        engine.ENGINE.get("inject", srv._spec(bucket=inject_bucket))(
            *rows, *srv._scalars(0, 0, 0))
        del rows
    inject_replays0 = sum(g.replays for g in engine.ENGINE.graphs(srv._bind)
                          if g.name.startswith("serving.inject@"))
    spills, restores, recs, chunks = [], [], [], []
    fetch, drain = srv._spill_fetch, srv._drain_restores
    take = srv._pool.take_restores

    def timed_fetch(blocks):
        t0 = time.perf_counter()
        out = fetch(blocks)
        spills.append((len(blocks), time.perf_counter() - t0))
        return out

    def taken():
        got = take()
        recs.extend(got)
        return got

    def timed_drain():
        n = len(recs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drain()
        torch.cuda.synchronize()
        if len(recs) > n:
            restores.append((len(recs) - n, time.perf_counter() - t0))

    srv._spill_fetch, srv._drain_restores = timed_fetch, timed_drain
    srv._pool.take_restores = taken
    get = engine.ENGINE.get

    def counted_get(kind, spec):
        fn = get(kind, spec)
        if kind != "paged_prefill":
            return fn

        def counted(tokens, pos0, length, slot):
            chunks.append(tokens.shape[1])
            return fn(tokens, pos0, length, slot)
        return counted

    prof = {}

    def around(i):
        if i != len(waves) - 1:
            return contextlib.nullcontext()
        prof["p"] = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        return prof["p"]

    engine.ENGINE.get = counted_get
    try:
        res = wl.serve_waves(srv, waves, wl.NEW, around=around,
                             sync=torch.cuda.synchronize)
    finally:
        del engine.ENGINE.get
    last = res[-1]
    adm = wl.summarize(torch, prof["p"], last["admission_s"], 1,
                       PRESSURE_FAMILIES + wl.FAMILIES)
    out = {"name": name, "spill_mb": spill_mb, "build_s": build_s,
           "num_blocks": srv._pool.N, "waves": res,
           "ticks": sum(w["ticks"] for w in res),
           "tokens": sum(len(s) for w in res for s in w["streams"]),
           "wall_s": sum(w["wall_s"] for w in res),
           "admission_chunks": chunks,
           "stats": srv.stats(), "kv_pool": srv.load_stats()["kv_pool"],
           "inject_replays": sum(
               g.replays for g in engine.ENGINE.graphs(srv._bind)
               if g.name.startswith("serving.inject@")) - inject_replays0,
           "restore_runs": restore_runs(recs, srv._pool.bs),
           "spill_fetches": spills, "restores": restores,
           "last_wave_admission": adm}
    out["tokens_per_s"] = out["tokens"] / out["wall_s"]
    nb = sum(n for n, _ in spills)
    out["spill_ms_per_block"] = (1e3 * sum(w for _, w in spills) / nb
                                 if nb else None)
    nr = sum(n for n, _ in restores)
    out["restore_ms_per_block"] = (1e3 * sum(w for _, w in restores) / nr
                                   if nr else None)
    srv.close()
    return out


def drill_server(torch, wl, cfg, params, **kw):
    """A graphed main-path server (the main path's geometry) warmed up at
    the main path's prompts' buckets (and its budget width)."""
    srv = wl.make_server("main", params, cfg, **kw)
    srv.warmup(prompt_lens=wl.LENS)
    return srv


def drill_serve(torch, srv, prompts, new, priorities=None, on_tick=None):
    """Submit every prompt (with ``priorities``), tick until drained
    (``on_tick(srv)`` after each tick); returns the per-request
    outcomes."""
    pr = priorities or [0] * len(prompts)
    rids = [srv.submit(p, max_new_tokens=new, priority=q)
            for p, q in zip(prompts, pr)]
    for _ in range(20 * new):
        if not srv.pending():
            break
        srv.tick()
        if on_tick:
            on_tick(srv)
    if srv.pending():
        raise AssertionError("the server did not drain")
    torch.cuda.synchronize()
    return [srv.result(r) for r in rids]


def hold_streams(torch, gpt, params, cfg, prompts, got, ref, what,
                 tol=TIE_TOL):
    """Every stream of ``got`` against ``ref`` by the tie rule; returns
    the number equal throughout."""
    div = [check_tokens(torch, gpt, params, cfg, prompts[r], got[r], ref[r],
                        f"{what} request {r}", tol=tol)
           for r in range(len(prompts))]
    return sum(d is None for d in div)


def ladder_events(tl):
    return [e["args"]["action"] for e in tl.events("resilience.oom_degrade")]


def oom_drill(torch, gpt, wl, cfg, params, prompts, new, ref_async,
              faults, tl, tol=TIE_TOL, server_kw=None):
    """The OOM ladder on an async graphed main server (``server_kw``: more
    server options — a draft model, say): injected tick OOMs at checks 2,
    4, 6 and 8 walk it — async -> sync, cap 8 -> 4, 4 -> 2, 2 -> 1, each
    cap rung evicting the slots past it back to the queue with their
    progress carried.  Every stream is held to the unfaulted async serve's
    ``ref_async``.  Returns the drill's record."""
    tl.reset()
    faults.install("oom:tick:2,oom:tick:4,oom:tick:6,oom:tick:8")
    try:
        srv = drill_server(torch, wl, cfg, params, async_dispatch=True,
                           **(server_kw or {}))
        got = drill_serve(torch, srv, prompts, new)
        after = (srv._async, srv._admit_cap, srv.stats())
        srv.close()
    finally:
        faults.reset()
    rungs = ladder_events(tl)
    want = ["sync_dispatch", "admit_cap=4", "admit_cap=2", "admit_cap=1"]
    if rungs != want:
        raise AssertionError(f"the OOM ladder's rungs {rungs}, not {want}")
    if after[0] or after[1] != 1:
        raise AssertionError(f"after the drill: async {after[0]}, admit cap "
                             f"{after[1]}")
    ctr = after[2]
    if ctr.get("resilience.oom_evictions", 0) < 4 + 2 + 1:
        raise AssertionError(f"evictions: {ctr}")
    equal = hold_streams(torch, gpt, params, cfg, prompts, got, ref_async,
                         "oom drill", tol)
    return {"rungs": rungs, "counters": ctr, "streams_equal": equal,
            "streams": len(prompts)}


def budgeted_oom_drill(torch, gpt, wl, cfg, params, prompts, new, faults,
                       tl, tol=TIE_TOL):
    """A budgeted main server (``prefill_budget=64``) hit by a tick OOM
    while its longest prompt (lowest priority) is admitting: the ladder's
    cap rung evicts that half-prefilled slot back to the queue with its
    original prompt; it claims its slot again and finishes.  Streams held
    to the unfaulted budgeted serve's."""
    pr = [0 if n == max(map(len, prompts)) else 1 for n in map(len, prompts)]
    srv = drill_server(torch, wl, cfg, params, prefill_budget=BUDGET)
    ref = drill_serve(torch, srv, prompts, new, pr)
    srv.close()
    tl.reset()
    victims = []
    faults.install("oom:tick:2")
    try:
        srv = drill_server(torch, wl, cfg, params, prefill_budget=BUDGET)
        evict = srv._evict_one

        def watched():
            slot = min(srv._slots, key=lambda s: (
                srv._slots[s]["priority"], -srv._slots[s]["t_submit"]))
            st = srv._slots[slot]
            victims.append((st["rid"], bool(st.get("admitting")),
                            len(st["generated"])))
            return evict()

        srv._evict_one = watched
        got = drill_serve(torch, srv, prompts, new, pr)
        ctr = srv.stats()
        srv.close()
    finally:
        faults.reset()
    long_rid = pr.index(0)
    if not any(rid == long_rid and adm for rid, adm, _ in victims):
        raise AssertionError(f"the long prompt was not evicted while "
                             f"admitting: {victims}")
    if ctr.get("serving.admitting_claims", 0) < sum(
            len(p) > BUDGET for p in prompts) + 1:
        raise AssertionError(f"no second claim: {ctr}")
    equal = hold_streams(torch, gpt, params, cfg, prompts, got, ref,
                         "budgeted oom drill", tol)
    return {"victims": victims, "counters": ctr, "streams_equal": equal,
            "streams": len(prompts), "rungs": ladder_events(tl)}


def wedge_drill(torch, gpt, wl, cfg, params, prompts, new, ref_async,
                faults, tl, tol=TIE_TOL, server_kw=None,
                spec="wedge:tick:2"):
    """The wedge watchdog on an async graphed main server (``server_kw``
    as in :func:`oom_drill`): ``PADDLE_TPU_STEP_BUDGET_S=0.5`` and a
    ``hang`` fault (``PADDLE_TPU_FAULT_WEDGE_S=2``) on the second check
    of the tick sites that take one — the async fetch, as a plain
    server's dispatch sites pass wedge faults by (a speculating server's
    verify is a synchronous site that would take it: ``spec`` names a
    fetch instead): ``wedged`` is set by that tick and cleared by the
    next clean one; the streams are the unfaulted async serve's."""
    flags_seen = []
    os.environ.update(PADDLE_TPU_STEP_BUDGET_S="0.5",
                      PADDLE_TPU_FAULT_WEDGE_S="2")
    tl.reset()
    faults.install(spec)
    try:
        srv = drill_server(torch, wl, cfg, params, async_dispatch=True,
                           **(server_kw or {}))
        got = drill_serve(torch, srv, prompts, new,
                          on_tick=lambda s: flags_seen.append(s.wedged))
        ctr = srv.stats()
        srv.close()
    finally:
        faults.reset()
        for k in ("PADDLE_TPU_STEP_BUDGET_S", "PADDLE_TPU_FAULT_WEDGE_S"):
            del os.environ[k]
    i = flags_seen.index(True) if True in flags_seen else None
    if i is None or flags_seen[i + 1] or any(flags_seen[i + 1:]):
        raise AssertionError(f"wedged after each tick: {flags_seen}")
    if tl.counter("resilience.wedge_detected") != 1 \
            or ctr.get("resilience.wedge_recoveries") != 1:
        raise AssertionError(f"wedge counters: {tl.counters('resilience')}")
    equal = hold_streams(torch, gpt, params, cfg, prompts, got, ref_async,
                         "wedge drill", tol)
    return {"wedged_at_tick": i, "ticks": len(flags_seen),
            "streams_equal": equal, "streams": len(prompts)}


def real_oom(torch, wl, cfg, params, prompt, new, resilience):
    """A real ``torch.cuda.OutOfMemoryError``: a graphed main server serves
    one request; an allocation past what the card has free fails,
    ``resilience.is_oom`` classifies it, ``empty_cache`` runs, and the
    same server serves the request again — the same stream."""
    srv = drill_server(torch, wl, cfg, params)
    before = drill_serve(torch, srv, [prompt], new)[0]
    free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(free + (1 << 30), dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as e:
        caught = e
    else:
        raise AssertionError("an allocation past the free memory succeeded")
    if not resilience.is_oom(caught):
        raise AssertionError(f"is_oom({caught!r}) is False")
    torch.cuda.empty_cache()
    after = drill_serve(torch, srv, [prompt], new)[0]
    srv.close()
    if after != before:
        raise AssertionError("the stream changed after the real OOM")
    return {"free_gb": free / 1e9, "total_gb": total / 1e9,
            "error": str(caught).splitlines()[0][:120],
            "is_oom": True, "stream_unchanged": True}


def ttl_and_nan(torch, wl, cfg, params, prompts, new, faults, resilience,
                server_kw=None):
    """TTL: a request queued behind 8 busy slots with ``ttl_s=0.001``
    past its wait is ``timeout`` and ``result`` raises
    ``DeadlineExceeded``; the 8 finish.  NaN: ``corrupt_nan`` on the
    first tick's logits (``nan:logits:2``: check 1 is its admission; a
    speculating server's first tick is a verify round) fails exactly the
    request decoding then; the requests submitted after it finish.
    ``server_kw`` as in :func:`oom_drill`."""
    srv = drill_server(torch, wl, cfg, params, **(server_kw or {}))
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    doomed = srv.submit(prompts[0], max_new_tokens=new, ttl_s=0.001)
    time.sleep(0.01)
    while srv.pending():
        srv.tick()
    if srv.status(doomed) != "timeout":
        raise AssertionError(f"status {srv.status(doomed)}, not timeout")
    try:
        srv.result(doomed)
    except resilience.DeadlineExceeded:
        pass
    else:
        raise AssertionError("result() of a shed request did not raise")
    if any(srv.status(r) != "ok" for r in rids):
        raise AssertionError("a live request did not finish")
    faults.install("nan:logits:2")
    try:
        bad = srv.submit(prompts[1], max_new_tokens=new)
        srv.tick()
    finally:
        faults.reset()
    if srv.status(bad) != "error":
        raise AssertionError(f"the poisoned request is {srv.status(bad)}")
    ok = drill_serve(torch, srv, prompts[2:4], new)
    srv.close()
    if not all(len(s) == new for s in ok):
        raise AssertionError("a request after the NaN did not finish")
    return {"shed": "timeout", "nan_failed": "error",
            "after_nan_finished": len(ok)}


def small_oom_drill(torch, gpt, serving, faults, tl):
    """The OOM ladder's drill on the small fp32 models (contiguous and
    paged): injected OOMs at checks 2, 4 and 6 of an async graphed server
    (async -> sync, cap 4 -> 2 -> 1; paged, the evict rung first while
    the prefix index holds cold entries): streams held to the unfaulted
    async server's, exactly where the evicted requests' carried tokens prefill
    to the decode steps' argmax (PATH_TOL, the two routes' logit gap, at
    most).  Returns {case: requests equal throughout}."""
    out = {}
    for name, cfg, kv in list(_small_models(torch, gpt))[:2]:
        params = gpt.init_params(cfg, seed=1, device="cuda")
        gen = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in (5, 40, 100, 17)]
        for layout in ("contiguous", "paged"):
            lay = (dict(layout="paged", block_size=16) if layout == "paged"
                   else {})

            def run(spec):
                tl.reset()
                if spec:
                    faults.install(spec)
                try:
                    srv = serving.DecodeServer(params, cfg, max_batch=4,
                                               max_len=160, device="cuda",
                                               async_dispatch=True, **lay)
                    got = drill_serve(torch, srv, prompts, 24)
                    srv.close()
                finally:
                    faults.reset()
                return got

            ref = run("")
            got = run("oom:tick:2,oom:tick:4,oom:tick:6")
            rungs = ladder_events(tl)
            # paged, an injected OOM takes the first rung while the prefix
            # index holds cold entries (the retired requests' prompts)
            walk = [r for r in rungs if r != "evict_prefix_cache"]
            if len(rungs) != 3 or walk != ["sync_dispatch", "admit_cap=2",
                                           "admit_cap=1"][:len(walk)] \
                    or (layout == "contiguous" and len(walk) != 3):
                raise AssertionError(f"{name} {layout}: rungs {rungs}")
            out[f"{name} {layout}"] = hold_streams(
                torch, gpt, params, cfg, prompts, got, ref,
                f"{name} {layout} oom drill", PATH_TOL)
        del params
    return out


def pressure_phase(torch, gpt, serving, engine, ks, wl):
    """The pressure phase (module note, phase 9): the paged spill tier
    under six waves of chat traffic, then the drills on the main path.
    Returns (stats, launches, tc, tick)."""
    from paddle_tpu_torch import faults, resilience
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.ops.decode_attention import R_TC

    zero_counts(ks)
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_layers
    waves = wl.pressure_waves(cfg.vocab_size, seed=0)
    serves = {}
    for name, spill_mb, blocks in (("roomy", 0, 512),
                                   ("spill", wl.PRESSURE_SPILL_MB, None),
                                   ("evict", 0, None)):
        gc.collect()
        torch.cuda.empty_cache()
        launch0, tc0, tick0 = (launch_counts(ks), tc_counts(ks),
                               tick_counts(ks))
        r = serves[name] = pressure_serve(torch, engine, wl, cfg, params,
                                          waves, name, spill_mb, blocks)
        dl = {k: v - launch0[k] for k, v in launch_counts(ks).items()}
        dtc = {k: v - tc0[k] for k, v in tc_counts(ks).items()}
        dtk = {k: v - tick0[k] for k, v in tick_counts(ks).items()}
        narrow = sum(C < R_TC for C in r["admission_chunks"])
        wide = len(r["admission_chunks"]) - narrow
        # every attention of the serve on the block-table kernel, each tick
        # and narrow chunk on its tick body, each wide chunk on its
        # tensor-core body — the restores' admissions included
        if not (dl["paged_decode_attention"] == L * (r["ticks"] + len(
                r["admission_chunks"])) and dtk["paged_decode_attention"]
                == L * (r["ticks"] + narrow)
                and dtc["paged_decode_attention"] == L * wide
                and dl["decode_attention"] == 0
                and dl["flash_attention_fwd"] == 0):
            raise AssertionError(f"{name}: launches {dl}, tc {dtc}, tick "
                                 f"{dtk}, {r['ticks']} ticks, chunks "
                                 f"{r['admission_chunks']}")
        a = r["last_wave_admission"]
        log(f"  {name} serve (num_blocks {r['num_blocks']}, spill "
            f"{spill_mb} MiB, server built in {r['build_s']:.3f} s): "
            f"{r['tokens']} tokens in {r['wall_s']:.3f} s "
            f"({r['tokens_per_s']:.1f} tokens/s, {r['ticks']} ticks); per "
            f"wave prefilled rows "
            f"{[w['prefill_rows'] for w in r['waves']]} of "
            f"{[w['prompt_rows'] for w in r['waves']]}, spilled "
            f"{[w['spilled_blocks'] for w in r['waves']]}, restored "
            f"{[w['restored_blocks'] for w in r['waves']]} blocks")
        log(f"  {name} serve, the returning wave's admissions: wall "
            f"{1e3 * r['waves'][-1]['admission_s']:.3f} ms (profiled), "
            f"device {a['device_ms']:.3f} ms by family "
            f"{json.dumps(a['device_ms_by_family'])}")
        if r["spill_ms_per_block"] is not None:
            log(f"  {name} serve: spill {r['spill_ms_per_block']:.4f} ms a "
                f"block ({sum(n for n, _ in r['spill_fetches'])} blocks in "
                f"{len(r['spill_fetches'])} fetches), restore "
                f"{r['restore_ms_per_block']:.4f} ms a block "
                f"({sum(n for n, _ in r['restores'])} blocks, "
                f"{r['inject_replays']} inject replays), host spill "
                f"{r['kv_pool']['host_spill_bytes'] / 2**20:.1f} MiB")
    sp, ev, rm = serves["spill"], serves["evict"], serves["roomy"]
    last = sp["waves"][-1]
    if not (sp["kv_pool"]["spilled_blocks"] > 0
            and last["restored_blocks"] > 0
            and last["prefix_hits"] >= 8 * 192
            and last["prefill_rows"] == last["prompt_rows"]
            - last["prefix_hits"]):
        raise AssertionError(f"the spill serve: {sp['kv_pool']}, last wave "
                             f"{ {k: v for k, v in last.items() if k != 'streams'} }")
    if sp["inject_replays"] != sp["restore_runs"] or not sp["restore_runs"]:
        raise AssertionError(f"{sp['inject_replays']} inject replays for "
                             f"{sp['restore_runs']} restored runs")
    if rm["stats"].get("resilience.oom_retries") \
            or rm["kv_pool"]["spilled_blocks"]:
        raise AssertionError(f"the roomy serve relieved its pool: "
                             f"{rm['stats']}")
    flat = [p for w in waves for p in w]
    equal = {}
    for name in ("spill", "evict"):
        got = [s for w in serves[name]["waves"] for s in w["streams"]]
        ref = [s for w in rm["waves"] for s in w["streams"]]
        equal[name] = hold_streams(torch, gpt, params, cfg, flat, got, ref,
                                   f"{name} serve vs roomy")
    tails = sum(len(p) - wl.PREFIX for p in waves[-1])
    ev_last = ev["waves"][-1]
    log(f"  the returning wave: prefilled rows {last['prefill_rows']} "
        f"restored vs {ev_last['prefill_rows']} evict-only (tails "
        f"{tails}); admission device "
        f"{sp['last_wave_admission']['device_ms']:.3f} ms restored vs "
        f"{ev['last_wave_admission']['device_ms']:.3f} ms recomputed; "
        f"streams equal to the roomy serve's: {equal}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the drills, on the main path's model and prompts
    cfg, params, srv, prompts = wl.build_main_path("cuda", seed=0)
    srv.close()
    new = wl.NEW
    ref = drill_server(torch, wl, cfg, params, async_dispatch=True)
    ref_async = drill_serve(torch, ref, prompts, new)
    ref.close()
    drills = {"oom": oom_drill(torch, gpt, wl, cfg, params, prompts, new,
                               ref_async, faults, tl)}
    log(f"  OOM drill: rungs {drills['oom']['rungs']}, evictions "
        f"{drills['oom']['counters'].get('resilience.oom_evictions')}, "
        f"{drills['oom']['streams_equal']} of {len(prompts)} streams equal "
        f"throughout to the unfaulted async serve's (the rest by the tie "
        f"rule)")
    drills["budgeted_oom"] = budgeted_oom_drill(torch, gpt, wl, cfg, params,
                                                prompts, new, faults, tl)
    log(f"  budgeted OOM drill: victims (rid, admitting, generated) "
        f"{drills['budgeted_oom']['victims']}, rungs "
        f"{drills['budgeted_oom']['rungs']}, "
        f"{drills['budgeted_oom']['streams_equal']} of {len(prompts)} "
        f"streams equal throughout")
    drills["wedge"] = wedge_drill(torch, gpt, wl, cfg, params, prompts, new,
                                  ref_async, faults, tl)
    log(f"  wedge drill: wedged after tick {drills['wedge']['wedged_at_tick']}"
        f", cleared by the next; {drills['wedge']['streams_equal']} of "
        f"{len(prompts)} streams equal throughout")
    drills["real_oom"] = real_oom(torch, wl, cfg, params, prompts[0], new,
                                  resilience)
    log(f"  real OOM: {json.dumps(drills['real_oom'])}")
    drills["ttl_nan"] = ttl_and_nan(torch, wl, cfg, params, prompts, new,
                                    faults, resilience)
    log(f"  TTL and NaN: {json.dumps(drills['ttl_nan'])}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    drills["small_fp32_oom"] = small_oom_drill(torch, gpt, serving, faults,
                                               tl)
    log(f"  small fp32 models, OOM drill: requests equal throughout "
        f"{drills['small_fp32_oom']} (of 4 each)")
    launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    stats = {
        "serves": {k: {kk: vv for kk, vv in v.items()
                       if kk not in ("waves", "spill_fetches", "restores")}
                   | {"waves": [{kk: vv for kk, vv in w.items()
                                 if kk != "streams"} for w in v["waves"]]}
                   for k, v in serves.items()},
        "streams_equal_to_roomy": equal, "returning_wave_tails": tails,
        "drills": drills, "launches": launches, "tc_launches": tc,
        "tick_launches": tick}
    return stats, launches


# -- the overload phase: admission control and the metrics plane ----------

# one line of Prometheus text exposition: a sample, or a TYPE comment
PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?) '
    r'([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$')
PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                       r"(counter|gauge|histogram)$")


def parse_prometheus(body):
    """{name{labels}: value} of one exposition body; raises on a line that
    is neither a ``# TYPE name kind`` comment nor ``name{labels} value``."""
    out = {}
    for line in body.splitlines():
        if PROM_TYPE.match(line):
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"not Prometheus text: {line!r}")
        out[m.group(1)] = float(m.group(2))
    return out


def http_get(url):
    """(status, body) of a GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Scraper:
    """GET ``url`` (a /metrics endpoint) every ``period`` seconds on a
    thread until :meth:`stop`; every body parsed line by line as
    Prometheus text, the value of ``series`` kept per scrape."""

    def __init__(self, url, period=0.1, series=None):
        import threading

        self.url, self.period, self.series = url, period, series
        self.values, self.errors, self.scrapes = [], [], 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                code, body = http_get(self.url)
                if code != 200:
                    raise AssertionError(f"/metrics answered {code}")
                samples = parse_prometheus(body)
                self.scrapes += 1
                if self.series is not None:
                    self.values.append(samples.get(self.series))
            except Exception as e:  # noqa: BLE001 - reported by stop()
                self.errors.append(repr(e))
            self._stop.wait(max(0.0, self.period
                                - (time.perf_counter() - t0)))

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        if self.errors:
            raise AssertionError(f"scrapes failed: {self.errors[:3]}")
        return self


@contextlib.contextmanager
def env_set(**kv):
    """Set environment flags for the block (a None value unsets one),
    then put them back."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def overload_server(wl, cfg, params, env=None, **kw):
    """A graphed main-path server at the overload budget (ladder widths
    64, 32, 16), built under ``env`` (admission control reads its flags
    at construction) and warmed up at the main prompts' widths — every
    ladder width among them."""
    with env_set(**(env or {})):
        srv = wl.make_server("main", params, cfg,
                             prefill_budget=wl.OVERLOAD_BUDGET, **kw)
    srv.warmup(prompt_lens=wl.LENS)
    return srv


def graph_replays(engine, srv):
    return {g.name: g.replays for g in engine.ENGINE.graphs(srv._bind)}


def ladder_arm(torch, gpt, engine, wl, cfg, params, ks, tl, ref, gap_p50):
    """The ladder arm (module note, the overload phase): the overload
    traffic on a budgeted server whose decode-gap objective is half the
    unloaded p50, scraped at 10 Hz.  Returns its record and the serve's
    launches."""
    L = cfg.num_layers
    W = wl.OVERLOAD_WINDOW_S
    slo = gap_p50 / 2
    srv = overload_server(wl, cfg, params, env=dict(
        PADDLE_TPU_SLO_TPOT_MS=repr(slo),
        PADDLE_TPU_SLO_WINDOW_S=repr(W)), metrics_port=0)
    adm = srv._adm
    assert adm.budget_rungs == (64, 32, 16), adm.budget_rungs
    graphs0 = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    replays0 = graph_replays(engine, srv)
    claims = []
    claim = srv._claim_admitting

    def watched(slot, st):
        claim(slot, st)
        claims.append({"rid": st["rid"], "width": st["admit_w"],
                       "chunks": len(st["admit_starts"]), "rung": adm.rung,
                       "budget": srv._effective_budget(),
                       "t": time.perf_counter() - t0})

    srv._claim_admitting = watched
    waves = wl.overload_waves(cfg.vocab_size, seed=0)
    prompts = wl.main_prompts(cfg.vocab_size, seed=0)
    index = {tuple(p): i for i, p in enumerate(prompts)}
    scraper = Scraper(f"http://127.0.0.1:{srv.metrics_server.port}/metrics",
                      0.1, "paddle_tpu_admission_rung")
    torch.cuda.synchronize()
    tl.reset()
    subs, timeline, walls = [], [], []
    pending = list(waves)
    zero_counts(ks)
    scraper.start()
    t0 = time.perf_counter()
    i = 0
    while srv.pending() or pending:
        if pending and time.perf_counter() - t0 >= wl.OVERLOAD_EVERY_S * (
                len(waves) - len(pending)):
            for prompt, q in pending.pop(0):
                rid = srv.submit(prompt, max_new_tokens=wl.NEW, priority=q)
                subs.append({"rid": rid, "prompt": index[tuple(prompt)],
                             "class": q, "rung": adm.rung,
                             "status": srv.status(rid)})
        if not srv.pending():           # drained before the next batch
            time.sleep(1e-3)
            continue
        t1 = time.perf_counter()
        srv.tick()
        walls.append(time.perf_counter() - t1)
        state = (adm.rung, adm.budget_level)
        if not timeline or timeline[-1][2:] != state:
            timeline.append((i, round(time.perf_counter() - t0, 4),
                             *state))
        i += 1
        if time.perf_counter() - t0 > 120:
            raise AssertionError("the ladder serve did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    scraper.stop()
    compiles = tl.compile_log()
    replays = graph_replays(engine, srv)
    graphs1 = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    ls = srv.load_stats(include_spans=True)
    # the drain: idle rounds until the ladder is back at rung 0
    drain = []
    t_idle = time.perf_counter()
    while adm.rung > 0 and time.perf_counter() - t_idle < 20 * W:
        before = adm.rung
        srv.tick()
        if adm.rung != before:
            drain.append((before, adm.rung,
                          round(time.perf_counter() - t_idle, 4)))
        time.sleep(W / 8)
    ctr = tl.counters("admission.")
    srv.close()

    # gates
    if max(r for _, _, r, _ in timeline) != 4:
        raise AssertionError(f"the ladder never reached rung 4: {timeline}")
    widths = [c["width"] for c in claims]
    walk = [w for k, w in enumerate(widths) if k == 0 or w != widths[k - 1]]
    if walk != [64, 32, 16] or any(c["width"] != c["budget"]
                                   for c in claims):
        raise AssertionError(f"claimed widths walk {walk}: {claims}")
    rejected = [s for s in subs if s["status"] == "rejected"]
    if not rejected or any(s["class"] != 0 or s["rung"] < 4
                           for s in rejected) \
            or any(s["class"] == 0 and s["rung"] >= 4
                   and s["status"] != "rejected" for s in subs):
        raise AssertionError(f"rejections: {subs}")
    if graphs1 != graphs0 or compiles:
        raise AssertionError(f"captures after warmup: {graphs1 - graphs0}, "
                             f"recompile records {compiles}")
    chunks = {w: replays.get(f"serving.prefill_chunk@{w}", 0)
              - replays0.get(f"serving.prefill_chunk@{w}", 0)
              for w in (64, 32, 16)}
    planned = {w: sum(c["chunks"] for c in claims if c["width"] == w)
               for w in (64, 32, 16)}
    mono = replays.get("serving.prefill@64", 0) \
        - replays0.get("serving.prefill@64", 0)
    if chunks != planned:
        raise AssertionError(f"chunk replays {chunks}, planned {planned}")
    n_chunks = sum(chunks.values())
    if not (tc["decode_attention"] == L * n_chunks
            and tick["decode_attention"] == launches["decode_attention"]
            - L * n_chunks and tick["decode_attention"] > 0
            and launches["flash_attention_fwd"] == L * mono
            and launches["paged_decode_attention"] == 0):
        raise AssertionError(f"launches {launches}, tc {tc}, tick {tick}, "
                             f"{n_chunks} chunks, {mono} monolithic")
    if not drain or drain[0][1] != 0:
        raise AssertionError(f"after the drain the rung went {drain}")
    seen = [v for v in scraper.values if v is not None]
    if not seen or max(seen) != 4 or not any(
            b > a for a, b in zip(seen, seen[1:])):
        raise AssertionError(f"scraped rungs {seen}")
    ok = [s for s in subs if s["status"] != "rejected"]
    spans = ls["spans"]
    kinds = {k: sum(sp["name"] == k for sp in spans)
             for k in ("prefill", "decode", "retire")}
    if kinds != {k: len(ok) for k in kinds} or ls["span_drops"]:
        raise AssertionError(f"spans {kinds} for {len(ok)} requests, "
                             f"{ls['span_drops']} dropped")
    equal = 0
    for s in ok:
        got = srv._results[s["rid"]]
        p = s["prompt"]
        equal += check_tokens(torch, gpt, params, cfg, prompts[p], got,
                              ref[p], f"ladder request {s['rid']}") is None
    per_class = {c: sum(s["status"] == "rejected" for s in subs
                        if s["class"] == c) for c in range(3)}
    return {"slo_tpot_ms": slo, "window_s": W, "requests": len(subs),
            "ticks": len(walls), "wall_s": wall,
            "tokens": sum(len(srv._results[s["rid"]]) for s in ok),
            "tick_ms_median": 1e3 * statistics.median(walls),
            "timeline": timeline, "claims": [(c["width"], c["rung"],
                                              round(c["t"], 4))
                                             for c in claims],
            "walk": walk, "rejected_per_class": per_class,
            "rejected_at": [(s["rid"], s["class"], s["rung"])
                            for s in rejected],
            "chunk_replays": chunks, "monolithic": mono,
            "drain": drain, "counters": ctr, "scrapes": scraper.scrapes,
            "scraped_rungs": seen, "spans": kinds,
            "streams_equal": equal, "streams": len(ok),
            "launches": launches, "tc_launches": tc,
            "tick_launches": tick}, launches


def tenant_arm(torch, wl, cfg, params, prompts, rate, tl):
    """Two tenants flood a budgeted server whose tenant rate is ``rate``
    tokens/s: each round both submit the same prompt, then one tick, for
    64 rounds; then the drain.  Gated: admitted tokens within 20% of each
    other and some throttles."""
    srv = overload_server(wl, cfg, params,
                          env=dict(PADDLE_TPU_TENANT_RATE=repr(rate)))
    tl.reset()
    subs = []
    t0 = time.perf_counter()
    for i in range(64):
        for tenant in ("a", "b"):
            rid = srv.submit(prompts[i % len(prompts)],
                             max_new_tokens=wl.NEW, tenant=tenant)
            subs.append((tenant, rid))
        srv.tick()
    flood = time.perf_counter() - t0
    while srv.pending():
        srv.tick()
    torch.cuda.synchronize()
    admitted = dict(srv._adm.admitted_tokens)
    status = {t: [srv.status(r) for tt, r in subs if tt == t]
              for t in ("a", "b")}
    throttles = tl.counter("admission.tenant_throttles")
    srv.close()
    a, b = admitted.get("a", 0), admitted.get("b", 0)
    if not (min(a, b) > 0 and abs(a - b) <= 0.2 * max(a, b)
            and throttles > 0) or any(
            s not in ("ok", "rejected") for v in status.values() for s in v):
        raise AssertionError(f"tenants: admitted {admitted}, throttles "
                             f"{throttles}, statuses {status}")
    return {"rate": rate, "flood_s": flood, "admitted_tokens": admitted,
            "throttles": throttles,
            "admitted_requests": {t: v.count("ok") for t, v in
                                  status.items()},
            "rejected_requests": {t: v.count("rejected") for t, v in
                                  status.items()}}


QUEUE_CLASSES = (0, 1, 2, 0, 1, 0, 2, 1,          # admitted at once
                 0, 1, 0, 2, 0, 1, 0, 2, 0, 1, 0, 1, 2, 0, 1, 0)


def queue_arm(torch, wl, cfg, params, prompts):
    """A burst of 24 mixed-class submits on a budgeted server with
    ``PADDLE_TPU_ADMISSION_QUEUE_CAP=4``: the first 8 take the slots, the
    rest queue by class.  Gated: the rejected requests are exactly the
    newest entries past the cap of each over-cap class (the lowest
    over-cap class sheds; at each submit only the submitted class can be
    over), and the queued requests are admitted class 2 first, then 1,
    then 0."""
    cap = 4
    srv = overload_server(wl, cfg, params,
                          env=dict(PADDLE_TPU_ADMISSION_QUEUE_CAP=str(cap)))
    rids = [srv.submit(prompts[k % len(prompts)], max_new_tokens=wl.NEW,
                       priority=q) for k, q in enumerate(QUEUE_CLASSES)]
    queued = {c: [] for c in range(3)}
    for rid, q in zip(rids[srv.max_batch:], QUEUE_CLASSES[srv.max_batch:]):
        queued[q].append(rid)
    want = sorted(r for c in range(3) for r in queued[c][cap:])
    got = sorted(r for r in rids if srv.status(r) == "rejected")
    cls = dict(zip(rids, QUEUE_CLASSES))
    waiting = {r for r in rids if srv.status(r) == "queued"}
    order, skipped = [], []
    while srv.pending():
        srv.tick()
        now = [r for r in waiting if srv.status(r) != "queued"]
        waiting.difference_update(now)
        # admitted this round, highest class first (the queue's order);
        # none of a class lower than one still waiting
        order += sorted((cls[r] for r in now), reverse=True)
        if now and waiting and min(cls[r] for r in now) < max(
                cls[r] for r in waiting):
            skipped.append((now, sorted(waiting)))
    torch.cuda.synchronize()
    done = sum(srv.status(r) == "ok" for r in rids)
    srv.close()
    if got != want or skipped or done != len(rids) - len(want) \
            or not order or order[0] != 2:
        raise AssertionError(f"queue arm: rejected {got}, expected {want}, "
                             f"admission order by class {order}, passed "
                             f"over {skipped}")
    return {"cap": cap, "submits": len(rids), "rejected": got,
            "rejected_classes": [QUEUE_CLASSES[rids.index(r)] for r in got],
            "queued_admission_order": order}


def healthz_and_trace_arm(torch, wl, cfg, params, prompts, faults, tl):
    """/healthz around the pressure phase's wedge drill (an async graphed
    main server, ``PADDLE_TPU_STEP_BUDGET_S=0.5``, a hung second fetch):
    200, then 503 while the server is wedged, then 200 after the next
    clean tick.  Then two requests served under ``torch.profiler`` (host and CUDA) on the
    same server, and ``telemetry.dump_chrome_trace`` of that profile with
    the requests' spans into chiprun_out/; and one card memory sample."""
    from torch.profiler import ProfilerActivity, profile

    codes = []
    with env_set(PADDLE_TPU_STEP_BUDGET_S="0.5",
                 PADDLE_TPU_FAULT_WEDGE_S="2"):
        faults.install("wedge:tick:2")
        try:
            srv = wl.make_server("main", params, cfg, async_dispatch=True,
                                 metrics_port=0)
            srv.warmup(prompt_lens=wl.LENS)
            url = f"http://127.0.0.1:{srv.metrics_server.port}/healthz"
            codes.append((False, http_get(url)[0]))
            rids = [srv.submit(p, max_new_tokens=16) for p in prompts[:2]]
            while srv.pending():
                srv.tick()
                codes.append((srv.wedged, http_get(url)[0]))
        finally:
            faults.reset()
    if not (codes[0] == (False, 200) and (True, 503) in codes
            and codes[-1] == (False, 200)
            and all((c == 503) == w for w, c in codes)):
        raise AssertionError(f"/healthz through the wedge drill: {codes}")
    assert all(srv.status(r) == "ok" for r in rids)
    srv.drain_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rids = [srv.submit(p, max_new_tokens=8) for p in prompts[:2]]
        while srv.pending():
            srv.tick()
        torch.cuda.synchronize()
    spans, drops = srv.drain_spans()
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "overload_trace.json")
    tl.dump_chrome_trace(out, profiler=prof, spans=spans)
    srv.close()
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in evs)
    names = {e.get("name") for e in evs}
    if not (kernels and {"prefill", "decode", "retire",
                         "serving.request"} <= names and not drops):
        raise AssertionError(f"trace: {kernels} kernel events, {drops} "
                             f"spans dropped, names {sorted(map(str, names))}")
    mem = tl.sample_device_stats(min_interval_s=0.0)
    if not mem or not mem.get("device0_bytes_in_use"):
        raise AssertionError(f"card memory sample {mem}")
    return {"healthz": [c for _, c in codes], "trace_events": len(evs),
            "trace_kernel_events": kernels, "trace_path": out,
            "device_stats": mem}


COST_WAYS = (("telemetry_off", dict(PADDLE_TPU_TELEMETRY="0"), False),
             ("telemetry_on", {}, False), ("scraped_10hz", {}, True))


def cost_arm(torch, wl, cfg, params, prompts, tl):
    """Main's 8 requests x 64 tokens on the main path's graphed server
    three ways — telemetry off, on, on and scraped at 10 Hz — in the order
    off, on, scraped, scraped, on, off; each way's tokens/s and tick ms
    (mean of its two serves' medians).  Gated: the streams equal across
    all six serves."""
    runs = {name: [] for name, _, _ in COST_WAYS}
    streams = {}
    for name, env, scrape in COST_WAYS + COST_WAYS[::-1]:
        gc.collect()
        torch.cuda.empty_cache()
        with env_set(**env):
            srv = wl.make_server("main", params, cfg,
                                 metrics_port=0 if scrape else None)
            srv.warmup(prompt_lens=wl.LENS)
            tl.reset()
            scraper = (Scraper(f"http://127.0.0.1:"
                               f"{srv.metrics_server.port}/metrics").start()
                       if scrape else None)
            torch.cuda.synchronize()
            served, _, ticks, wall = serve(torch, srv, prompts, wl.NEW)
            if scraper:
                scraper.stop()
            srv.close()
        n_tok = sum(map(len, served))
        runs[name].append({"tokens_per_s": n_tok / wall,
                           "tick_ms_median": 1e3 * statistics.median(ticks),
                           "tick_ms_mean": 1e3 * statistics.mean(ticks),
                           "scrapes": scraper.scrapes if scraper else 0})
        streams.setdefault("first", served)
        if served != streams["first"]:
            raise AssertionError(f"{name}: other streams than the first "
                                 f"way's")
    return {name: {"runs": r,
                   "tokens_per_s": statistics.mean(x["tokens_per_s"]
                                                   for x in r),
                   "tick_ms_median": statistics.mean(x["tick_ms_median"]
                                                     for x in r)}
            for name, r in runs.items()}


def overload_phase(torch, gpt, engine, ks, wl, card):
    """The overload phase (module note): admission control and the
    metrics plane on the main path.  Returns (stats, launches)."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch import telemetry as tl

    cfg, params, srv, prompts = wl.build_main_path("cuda", seed=0)
    srv.close()
    t_phase = time.perf_counter()
    # unloaded: the reference streams, the decode gap, tokens/s
    srv = overload_server(wl, cfg, params)
    tl.reset()
    ref, _, ticks, wall = serve(torch, srv, prompts, wl.NEW)
    gap_p50 = tl.hist("serving.decode_gap_ms").quantile(0.5)
    tok_s = sum(map(len, ref)) / wall
    srv.close()
    log(f"  unloaded (budget {wl.OVERLOAD_BUDGET}): {tok_s:.1f} tokens/s, "
        f"decode gap p50 {gap_p50:.4f} ms, tick median "
        f"{1e3 * statistics.median(ticks):.3f} ms [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    ladder, launches = ladder_arm(torch, gpt, engine, wl, cfg, params, ks,
                                  tl, ref, gap_p50)
    tok_s_ladder = ladder["tokens"] / ladder["wall_s"]
    log(f"  ladder: {ladder['requests']} requests, {ladder['ticks']} ticks "
        f"in {ladder['wall_s']:.3f} s ({tok_s_ladder:.1f} tokens/s, tick "
        f"median {ladder['tick_ms_median']:.3f} ms), decode "
        f"gap objective {ladder['slo_tpot_ms']:.4f} ms over "
        f"{ladder['window_s']} s windows [{card}]")
    log(f"  ladder timeline (tick, s, rung, budget level): "
        f"{ladder['timeline']}")
    log(f"  claims (width, rung, s): {ladder['claims']}; widths walk "
        f"{ladder['walk']}; chunk replays {ladder['chunk_replays']}")
    log(f"  rejected per class {ladder['rejected_per_class']} (rid, class, "
        f"rung) {ladder['rejected_at']}; drain {ladder['drain']}; "
        f"{ladder['streams_equal']} of {ladder['streams']} streams equal "
        f"throughout to the unloaded ones (the rest by the tie rule)")
    log(f"  metrics: {ladder['scrapes']} scrapes at 10 Hz parsed, rung "
        f"seen {ladder['scraped_rungs']}; spans {ladder['spans']}; "
        f"counters {json.dumps(ladder['counters'])}")
    gc.collect()
    torch.cuda.empty_cache()
    tenants = tenant_arm(torch, wl, cfg, params, prompts, tok_s / 2, tl)
    log(f"  tenants at {tok_s / 2:.1f} tokens/s each: {json.dumps(tenants)}")
    queue = queue_arm(torch, wl, cfg, params, prompts)
    log(f"  queue cap 4: {json.dumps(queue)}")
    health = healthz_and_trace_arm(torch, wl, cfg, params, prompts, faults,
                                   tl)
    log(f"  /healthz through the wedge drill {health['healthz']}; trace "
        f"{health['trace_events']} events, {health['trace_kernel_events']} "
        f"kernel events; card memory {json.dumps(health['device_stats'])}")
    gc.collect()
    torch.cuda.empty_cache()
    cost = cost_arm(torch, wl, cfg, params, prompts, tl)
    for name, c in cost.items():
        runs = [(round(r["tokens_per_s"], 1), round(r["tick_ms_median"], 4))
                for r in c["runs"]]
        log(f"  cost, {name}: tokens/s {c['tokens_per_s']:.1f}, tick median "
            f"{c['tick_ms_median']:.4f} ms (runs: tokens/s, tick median "
            f"{runs}) [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"unloaded": {"tokens_per_s": tok_s, "decode_gap_p50_ms": gap_p50},
            "ladder": ladder, "tenants": tenants, "queue": queue,
            "health": health, "cost": cost,
            "phase_s": time.perf_counter() - t_phase}, launches


# -- the device feed on the card, and the GPT-1.3B trees and servers the
#    other phases do not serve -----------------------------------------------

# what the smoke prints of each step's device feed
FEED_KEYS = ("flops", "bytes_accessed", "arithmetic_intensity", "bound",
             "step_s", "step_calls", "mfu", "hbm_bw_util", "argument_bytes",
             "output_bytes", "temp_bytes", "compiles")
# a step's bytes over its wall may not pass the card's peak rate by more
# than a rounding's worth: a count that did would be a broken count
HBM_UTIL_CAP = 1.05


def step_flops(cfg, batch, window):
    """The smoke's own count of one decode step's FLOPs, from the config:
    2 · batch · the matmul weights (qkv — GQA's narrower K and V —, the
    attention projection, the FFN, the tied logits head) plus 4 · batch ·
    window · hidden a layer for q·Kᵀ and p·V over the cache's window."""
    D, Fd, L, V = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                   cfg.vocab_size)
    Dkv = cfg.kv_heads * cfg.head_dim
    ffn = (3 if cfg.activation == "swiglu" else 2) * D * Fd
    weights = L * (D * (D + 2 * Dkv) + D * D + ffn) + D * V
    return 2 * batch * weights + 4 * batch * window * D * L


def counted_since(tl, since):
    """{step name: (flops, bytes_accessed)} of the builds the device feed
    counted since ``since`` (a ``time.time()``)."""
    return {n: (r.get("flops"), r.get("bytes_accessed"))
            for n, r in sorted(tl._step_analysis.items())
            if r["captured_at"] >= since}


def feed_gates(tl, cfg, what, since, step="serving.step", want=None):
    """The device feed of a gated serve, one line a step the serve's
    server built (since ``since``), then its gates: the decode step's
    (``step``) FLOPs are ``want`` — default :func:`step_flops` of the
    config at the server's 8 slots and 512-row window —, its MFU known
    and below 1, its HBM bandwidth use at most HBM_UTIL_CAP.  Returns the
    feed's rows."""
    feed = tl.device_feed()
    rows = {n: {k: feed["steps"][n].get(k) for k in FEED_KEYS}
            for n in counted_since(tl, since)}
    log(f"  {what}: device feed on {feed['device_kind']} (peaks "
        f"{feed['peak_flops']} FLOP/s, {feed['peak_hbm_bytes_per_s']} B/s)")
    for n, r in rows.items():
        log(f"    {n} {json.dumps(r)}")
    name = step
    step = rows.get(name, {})
    if want is None:
        want = step_flops(cfg, 8, 512)
    mfu, util = step.get("mfu"), step.get("hbm_bw_util")
    if step.get("flops") != want or mfu is None or not 0 < mfu < 1 \
            or util is None or util > HBM_UTIL_CAP:
        raise AssertionError(f"{what}: {name}'s feed {step}, not "
                             f"{want} FLOPs with 0 < mfu < 1 and "
                             f"hbm_bw_util <= {HBM_UTIL_CAP}")
    return {"device_kind": feed["device_kind"],
            "peak_flops": feed["peak_flops"],
            "peak_hbm_bytes_per_s": feed["peak_hbm_bytes_per_s"],
            "analytic_step_flops": want, "steps": rows}


def feed_small_vs_cpu(torch, gpt, serving, woq, tl):
    """The device feed counts a step by shape, so on the small fp32 models
    (MHA over an fp32 cache, GQA over an int8 one, an int4 tree on the W4
    kernel) every step a graphed card serve builds must count the FLOPs
    and bytes the same step counts in a CPU serve of the same requests,
    both layouts.  Returns {case: steps compared}."""
    out = {}
    models = list(_small_models(torch, gpt))
    # MHA over an fp32 cache, GQA over an int8 one, the int4 tree
    cases = [(f"{n} kv={kv or 'fp32'}", cfg, kv, False)
             for n, cfg, kv in (models[0], models[3])]
    cases.append(("mha-learned int4 W4", models[0][1], "", True))
    try:
        for name, cfg, kv, w4 in cases:
            os.environ["PADDLE_TPU_KV_DTYPE"] = kv
            os.environ["PADDLE_TPU_W4_KERNEL"] = "1" if w4 else "0"
            cpu = gpt.init_params(cfg, seed=3, device="cpu")
            if w4:
                cpu = woq.quantize_gpt_int4(cpu, group_size=32)
            card = _to_card(cpu)
            gen = torch.Generator().manual_seed(2)
            prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                     generator=gen).tolist()
                       for n in (5, 40, 100, 17)]
            for layout in ("contiguous", "paged"):
                lay = (dict(layout="paged", block_size=16)
                       if layout == "paged" else {})
                counts = {}
                for dev, p in (("cpu", cpu), ("cuda", card)):
                    since = time.time()
                    srv = serving.DecodeServer(p, cfg, max_batch=4,
                                               max_len=160, device=dev,
                                               **lay)
                    drill_serve(torch, srv, prompts, 4)
                    srv.close()
                    counts[dev] = counted_since(tl, since)
                if not counts["cpu"] or counts["cpu"] != counts["cuda"]:
                    raise AssertionError(f"{name} {layout}: the card's "
                                         f"counts {counts['cuda']}, the "
                                         f"CPU's {counts['cpu']}")
                out[f"{name} {layout}"] = len(counts["cpu"])
            del cpu, card
    finally:
        for k in ("PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_W4_KERNEL"):
            os.environ.pop(k, None)
    return out


def counted_admissions(engine, ks, calls):
    """Wrap ``Engine.get`` so that each admission call (a bucket prefill
    or a paged chunk: one graph replay each, counting the launches its
    capture recorded) appends (its width C, the tensor-core launches of
    the two decode kernels and the W4 launches and their tensor-core ones
    it added) to ``calls``.  Returns the unwrapping callable."""
    get = engine.ENGINE.get
    da_, pda, w4 = (ks["decode_attention"], ks["paged_decode_attention"],
                    ks["w4_matmul"])

    def counted_get(kind, spec):
        fn = get(kind, spec)
        if kind not in ("prefill", "paged_prefill", "moe_prefill",
                        "moe_paged_prefill"):
            return fn

        def counted(tokens, *rest):
            before = (da_.tc_launches + pda.tc_launches, w4.launches,
                      w4.tc_launches)
            out = fn(tokens, *rest)
            calls.append((tokens.shape[1],
                          da_.tc_launches + pda.tc_launches - before[0],
                          w4.launches - before[1], w4.tc_launches
                          - before[2]))
            return out
        return counted

    engine.ENGINE.get = counted_get

    def undo():
        del engine.ENGINE.get
    return undo


def tree_serve(torch, engine, wl, ks, path, cfg, params, prompts, new,
               step="serving.step", flops=None, **server_kw):
    """One graphed, warmed serve of ``path``'s geometry (``server_kw``:
    more server options), each admission and each tick's launches counted
    (:func:`counted_admissions`): every tick one replay of the step graph
    ``step`` and no graph captured after warmup, the step's FLOPs in the
    device feed ``flops`` (default :func:`step_flops` at 8 slots and a
    512-row window).  Returns (streams, stats with the per-call launch
    records, and ``srv``'s routing totals for an MoE server)."""
    from paddle_tpu_torch import telemetry as tl

    gc.collect()
    torch.cuda.empty_cache()
    srv = wl.make_server(path, params, cfg, **server_kw)
    since = time.time()
    warm = srv.warmup(prompt_lens=[len(p) for p in prompts])
    replays0 = replays_now(engine, srv, step)
    graphs0 = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    calls, per_tick = [], []
    w4 = ks["w4_matmul"]
    undo = counted_admissions(engine, ks, calls)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ks)
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
        t_admit = time.perf_counter() - t0
        ticks = []
        while srv.pending():
            before = (w4.launches, w4.tc_launches)
            t1 = time.perf_counter()
            srv.tick()
            ticks.append(time.perf_counter() - t1)
            per_tick.append((w4.launches - before[0],
                             w4.tc_launches - before[1]))
            if len(ticks) > 10 * new:
                raise AssertionError("server did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    served = [srv.result(r) for r in rids]
    graphed_serve(torch, engine, srv, ticks, replays0, len(calls), step)
    graphs1 = {g.name for g in engine.ENGINE.graphs(srv._bind)}
    if graphs1 != graphs0:
        raise AssertionError(f"{path}: the serve captured "
                             f"{sorted(graphs1 - graphs0)} after warmup")
    cache = srv._bind.cache
    stats = way_stats(torch, engine, srv, served, t_admit, ticks, wall, peak,
                      warm)
    if srv._moe_stats is not None:
        stats["moe_dropped_tokens"], stats["moe_expert_load"] = \
            srv._moe_snapshot()
    feed = tl.device_feed()["steps"]
    built = counted_since(tl, since)
    want = step_flops(cfg, 8, 512) if flops is None else flops
    row = {k: feed[step].get(k) for k in FEED_KEYS}
    if row["flops"] != want:
        raise AssertionError(f"{path}: {step}'s feed {row}, not {want} "
                             f"FLOPs")
    stats.update(
        feed_step=row,
        graph_pools_gb=sum(feed[n].get("temp_bytes") or 0
                           for n in built) / 1e9,
        kv_dtype=str(cache["k"].dtype).replace("torch.", ""),
        kv_bytes=sum(t.numel() * t.element_size() for n, t in cache.items()
                     if n != "tables"),
        launches=launches, tc_launches=tc, tick_launches=tick,
        admission_calls=calls, w4_per_tick=sorted(set(per_tick)))
    srv.close()
    return served, stats


def route_gates(cfg, path, st, da):
    """The launch gates of a :func:`tree_serve`: every attention of the
    serve on its layout's kernel (the paged one reads the pool in place:
    no contiguous decode launch and no flash forward), every tick on the
    tick body (R = G < R_TC), every main admission's flash forward on the
    tensor-core body, every paged chunk at R = C·G >= R_TC on the paged
    kernel's tensor-core body (the tick body below) — one launch a layer,
    or one a piece of at most ``_R_CAP`` rows a kv head past it."""
    L, G = cfg.num_layers, cfg.num_heads // cfg.kv_heads
    launches, tc, tick = st["launches"], st["tc_launches"], st["tick_launches"]
    n_tick, calls = st["calls"], st["admission_calls"]

    def pieces(C):
        return -(-C * G // da._R_CAP)

    ok = True
    if path == "main":
        ok &= launches["flash_attention_fwd"] == L * len(calls) \
            == tc["flash_attention_fwd"]
        ok &= launches["decode_attention"] == L * n_tick \
            == tick["decode_attention"]
        ok &= launches["paged_decode_attention"] == 0
        ok &= all(c[1] == 0 for c in calls)
    else:
        narrow = sum(c[0] * G < da.R_TC for c in calls)
        ok &= launches["paged_decode_attention"] == L * (
            n_tick + sum(pieces(c[0]) for c in calls))
        ok &= tick["paged_decode_attention"] == L * (n_tick + narrow)
        ok &= all(c[1] == L * pieces(c[0]) * (c[0] * G >= da.R_TC)
                  for c in calls)
        ok &= launches["decode_attention"] == 0
        ok &= launches["flash_attention_fwd"] == 0
    if not ok:
        raise AssertionError(f"{path}: launches {launches}, tc {tc}, tick "
                             f"{tick}, {n_tick} ticks, admissions "
                             f"(C, tc, w4, w4 tc) {calls}")


def tree_arm(torch, gpt, engine, wl, ks, path, cfg, params, prompts, new,
             what, da):
    """A tree on ``path``'s geometry, served eagerly, then graphed and
    warmed (:func:`tree_serve`): :func:`route_gates`; the graphed streams
    held to the eager ones by the tie rule, and every token of them
    within TIE_TOL of its row's best in a teacher-forced forward."""
    gc.collect()
    torch.cuda.empty_cache()
    eager = wl.make_server(path, params, cfg, _graphs=False)
    ref = serve(torch, eager, prompts, new)[0]
    eager.close()
    del eager
    served, st = tree_serve(torch, engine, wl, ks, path, cfg, params,
                            prompts, new)
    route_gates(cfg, path, st, da)
    st["eager_equal"] = hold_streams(torch, gpt, params, cfg, prompts,
                                     served, ref, f"{what} {path} graph vs "
                                     f"eager")
    st["forced_gap"] = max(forced_gap(torch, gpt, params, cfg, p, s)
                           for p, s in zip(prompts, served))
    if not st["forced_gap"] <= TIE_TOL:
        raise AssertionError(f"{what} {path}: a served token "
                             f"{st['forced_gap']} under its teacher-forced "
                             f"best (tol {TIE_TOL})")
    log(f"  {what} {path}: tokens/s {st['tokens_per_s']:.1f}, tick median "
        f"{st['tick_ms_median']:.2f} ms, reserved {st['reserved_gb']:.4f} "
        f"GB ({st['graph_pools_gb']:.4f} in graph pools), {st['kv_dtype']} "
        f"cache {st['kv_bytes'] / 1e9:.4f} GB; serving.step "
        f"{json.dumps(st['feed_step'])}; "
        f"{st['eager_equal']} of {len(prompts)} streams equal to eager "
        f"throughout (the rest by the tie rule), every token within "
        f"{st['forced_gap']:.4g} of its teacher-forced best; launches "
        f"{ {k: v for k, v in st['launches'].items() if v} }, tick body "
        f"{ {k: v for k, v in st['tick_launches'].items() if v} }, "
        f"tensor-core {({k: v for k, v in st['tc_launches'].items() if v})}")
    return st


def w4_paged_arm(torch, gpt, engine, wl, wm, ks, cfg, params, da):
    """The int4 tree (``W4_FLAGS`` set) on the paged path's geometry and
    chat requests (:func:`tree_serve`): :func:`route_gates`, and 6 W4
    launches a layer in every tick and in every chunk of at most
    ``_N_CAP`` rows (none past it), all on the tensor-core body; every
    token within TIE_TOL of its teacher-forced best (the int4 forward)."""
    L = cfg.num_layers
    prompts = wl.paged_prompts(cfg.vocab_size, 0)
    served, st = tree_serve(torch, engine, wl, ks, "paged", cfg, params,
                            prompts, wl.NEW)
    route_gates(cfg, "paged", st, da)
    want = [6 * L if c[0] <= wm._N_CAP else 0 for c in st["admission_calls"]]
    if [c[2] for c in st["admission_calls"]] != want \
            or [c[3] for c in st["admission_calls"]] != want \
            or st["w4_per_tick"] != [(6 * L, 6 * L)] \
            or st["tc_launches"]["w4_matmul"] != st["launches"]["w4_matmul"]:
        raise AssertionError(f"W4 paged: per admission (C, tc, w4, w4 tc) "
                             f"{st['admission_calls']} (want {want}), per "
                             f"tick {st['w4_per_tick']}, launches "
                             f"{st['launches']}, tc {st['tc_launches']}")
    st["forced_gap"] = max(forced_gap(torch, gpt, params, cfg, p, s)
                           for p, s in zip(prompts, served))
    if not st["forced_gap"] <= TIE_TOL:
        raise AssertionError(f"W4 paged: a served token {st['forced_gap']} "
                             f"under its teacher-forced best")
    log(f"  W4 paged: tokens/s {st['tokens_per_s']:.1f}, tick median "
        f"{st['tick_ms_median']:.2f} ms, reserved {st['reserved_gb']:.4f} "
        f"GB ({st['graph_pools_gb']:.4f} in graph pools); serving.step "
        f"{json.dumps(st['feed_step'])}; W4 launches per admission {[c[2] for c in st['admission_calls']]}"
        f" (widths {[c[0] for c in st['admission_calls']]}), per tick "
        f"{st['w4_per_tick']}, all on the tensor-core body; launches "
        f"{ {k: v for k, v in st['launches'].items() if v} }; every token "
        f"within {st['forced_gap']:.4g} of its teacher-forced best")
    return st


def drills_on(torch, gpt, wl, cfg, params, prompts, new, faults, tl,
              resilience, what, server_kw=None, wedge="wedge:tick:2",
              wedge_kw=None):
    """The pressure phase's drills on the main path's requests, on a server
    of ``params`` with ``server_kw``: the OOM ladder (rungs in order,
    evictions), the wedge watchdog, TTL and the NaN guard, each stream
    held by the tie rule to an unfaulted async serve's.  ``wedge`` and
    ``wedge_kw``: the wedge drill's fault and its extra server options."""
    kw = server_kw or {}
    ref = drill_server(torch, wl, cfg, params, async_dispatch=True, **kw)
    ref_async = drill_serve(torch, ref, prompts, new)
    ref.close()
    out = {"oom": oom_drill(torch, gpt, wl, cfg, params, prompts, new,
                            ref_async, faults, tl, server_kw=kw),
           "wedge": wedge_drill(torch, gpt, wl, cfg, params, prompts, new,
                                ref_async, faults, tl,
                                server_kw={**kw, **(wedge_kw or {})},
                                spec=wedge),
           "ttl_nan": ttl_and_nan(torch, wl, cfg, params, prompts, new,
                                  faults, resilience, server_kw=kw)}
    log(f"  {what} drills: OOM rungs {out['oom']['rungs']}, evictions "
        f"{out['oom']['counters'].get('resilience.oom_evictions')}, "
        f"{out['oom']['streams_equal']} of {len(prompts)} streams equal "
        f"throughout; wedged after tick {out['wedge']['wedged_at_tick']}, "
        f"cleared by the next, {out['wedge']['streams_equal']} streams "
        f"equal; TTL and NaN {json.dumps(out['ttl_nan'])}")
    return out


def trees_phase(torch, gpt, serving, woq, wm, engine, ks, wl, bf16):
    """[the GPT-1.3B trees the other phases bypass] — int8 KV and GQA
    (``num_kv_heads=4``, G = 4) on the main and paged paths
    (:func:`tree_arm`), the int4 tree on the paged path
    (:func:`w4_paged_arm`), and the pressure phase's drills on the int4
    tree and on a K = SPEC_K draft == target speculating server
    (:func:`drills_on`).  ``bf16``: the main and paged paths' stats of
    this run, printed beside.  Returns (stats, launches)."""
    import dataclasses

    from paddle_tpu_torch import faults, resilience
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.ops import decode_attention as da

    new = wl.NEW
    cfg = gpt.gpt_1p3b()
    by_path = {"main": wl.main_prompts(cfg.vocab_size, 0),
               "paged": wl.paged_prompts(cfg.vocab_size, 0)}
    arms, launches = {}, {}

    def tally(st):
        for n, v in st["launches"].items():
            launches[n] = launches.get(n, 0) + v

    params = gpt.init_params(cfg, seed=0, device="cuda")
    os.environ["PADDLE_TPU_KV_DTYPE"] = "int8"
    try:
        for path, prompts in by_path.items():
            arms[f"int8 {path}"] = st = tree_arm(
                torch, gpt, engine, wl, ks, path, cfg, params, prompts, new,
                "int8 KV", da)
            if st["kv_dtype"] != "int8":
                raise AssertionError(f"int8 {path}: a {st['kv_dtype']} cache")
            tally(st)
    finally:
        os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    for path in by_path:
        a, b = arms[f"int8 {path}"], bf16[path]
        log(f"  int8 KV {path} beside bf16 (this run): tokens/s "
            f"{a['tokens_per_s']:.1f} vs {b['tokens_per_s']:.1f}, tick "
            f"median {a['tick_ms_median']:.2f} vs {b['tick_ms_median']:.2f} "
            f"ms, reserved {a['reserved_gb']:.4f} vs "
            f"{b['ways']['graph']['reserved_gb']:.4f} GB")
    out_drills = {}
    # a speculating server's rounds are synchronous: its only async
    # fetches are the plain steps it takes while a budgeted claim admits,
    # so its wedge drill admits under BUDGET and hangs the second fetch
    out_drills["speculating"] = drills_on(
        torch, gpt, wl, cfg, params, by_path["main"], new, faults, tl,
        resilience, f"draft == target K = {SPEC_K}",
        dict(spec_k=SPEC_K, draft_cfg=cfg, draft_params=params),
        wedge="wedge:serving.fetch:2", wedge_kw=dict(prefill_budget=BUDGET))
    del params
    engine.ENGINE.purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()

    gcfg = dataclasses.replace(cfg, num_kv_heads=4)
    gparams = gpt.init_params(gcfg, seed=0, device="cuda")
    for path, prompts in by_path.items():
        arms[f"gqa {path}"] = st = tree_arm(
            torch, gpt, engine, wl, ks, path, gcfg, gparams, prompts, new,
            "GQA 16/4", da)
        tally(st)
    del gparams
    engine.ENGINE.purge(gcfg)
    gc.collect()
    torch.cuda.empty_cache()

    os.environ.update(wl.W4_FLAGS)
    try:
        w4 = woq.quantize_gpt_int4(gpt.init_params(cfg, seed=0,
                                                   device="cuda"),
                                   group_size=wl.W4_GROUP)
        arms["w4 paged"] = st = w4_paged_arm(torch, gpt, engine, wl, wm, ks,
                                             cfg, w4, da)
        tally(st)
        out_drills["w4"] = drills_on(torch, gpt, wl, cfg, w4,
                                     by_path["main"], new, faults, tl,
                                     resilience, "int4 W4")
    finally:
        os.environ.pop("PADDLE_TPU_W4_KERNEL", None)
    del w4
    engine.ENGINE.purge(cfg)
    stats = {"arms": {n: {k: v for k, v in a.items() if k not in (
        "launches", "tc_launches", "tick_launches")} for n, a in arms.items()},
        "drills": out_drills,
        "tick_launches": {n: sum(a["tick_launches"][n] for a in arms.values())
                          for n in ("decode_attention",
                                    "paged_decode_attention")},
        "tc_launches": {n: sum(a["tc_launches"][n] for a in arms.values())
                        for n in arms["w4 paged"]["tc_launches"]}}
    return stats, launches


# --------------------------------------------------------------------------
# MoE serving: GPT-1.3B widths with 8 top-2 experts a layer
# --------------------------------------------------------------------------

# the reference's MoEConfig defaults (paddle_tpu/text/moe.py:28-34), the
# expert geometry of the README's MoE serving example
MOE_E, MOE_K, MOE_CF = 8, 2, 1.25
# the full-width fp32 parity serve: main's first requests, fewer tokens
MOE_PARITY_REQUESTS, MOE_PARITY_NEW = 4, 32


def moe_config(gpt, moe, cf=MOE_CF, **over):
    """``gpt_1p3b()``'s widths (vocab 50304, hidden 2048, 24 layers, 16
    heads) with MOE_E top-MOE_K experts a layer at capacity factor
    ``cf``."""
    import dataclasses

    return dataclasses.replace(
        gpt.gpt_1p3b(), moe=moe.MoEConfig(num_experts=MOE_E, top_k=MOE_K,
                                          capacity_factor=cf,
                                          router_noise=0.0), **over)


def moe_step_flops(cfg, batch, window):
    """:func:`step_flops` with the routed FFN in place of the dense one: a
    layer's router (2·B·D·E), the dispatch and combine matmuls over the
    E·C capacity slots (2·E·C·B·D each) and every expert's two matmuls
    on its [C, D] buffer (4·E·C·D·F), C the capacity-factor bound over
    the batch's B tokens (3 at B = 8, E = 8, top-2, cf 1.25)."""
    D, Fd, L, V = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                   cfg.vocab_size)
    E = cfg.moe.num_experts
    C = max(1, math.ceil(batch * cfg.moe.top_k / E
                         * cfg.moe.capacity_factor))
    Dkv = cfg.kv_heads * cfg.head_dim
    weights = L * (D * (D + 2 * Dkv) + D * D) + D * V
    routed = L * (2 * batch * D * E + 4 * E * C * batch * D
                  + 4 * E * C * D * Fd)
    return 2 * batch * weights + 4 * batch * window * D * L + routed


def moe_train_flops_per_token(cfg, seq):
    """Training FLOPs a token by the weights it is routed through: the
    JAX package's count (``gpt.flops_per_token``, which sees one dense
    gelu FFN a block) plus, a block, the other k - 1 experts and the
    router: 6·((k - 1)·2·D·F + D·E).  The capacity slots' padding and the
    dispatch / combine matmuls are not counted, as the JAX count counts
    no routing.  A dense config: the JAX count."""
    from paddle_tpu_torch.text import gpt

    dense = gpt.flops_per_token(cfg, seq)
    if cfg.moe is None:
        return dense
    D, k, E = cfg.hidden_size, cfg.moe.top_k, cfg.moe.num_experts
    return dense + 6 * cfg.num_layers * ((k - 1) * 2 * D * cfg.ffn_size
                                         + D * E)


def moe_train_routing(torch, gpt, cfg, params, tokens, key):
    """The routing of micro-batch 0 (``tokens[:1]``) under its step key
    (``rng.fold_in(key, 0)``, as ``step_fn`` gives it), no grad: every
    layer's ``moe_ffn`` called with ``with_stats=True``.  Returns kept and
    dropped token→expert assignments over the layers, the drop rate and
    each expert's kept load; gates: every assignment counted once."""
    from paddle_tpu_torch import rng
    from paddle_tpu_torch.text import moe

    got = []
    real = moe.moe_ffn

    def counted(p, x, mcfg, key=None, **kw):
        y, aux, st = real(p, x, mcfg, key=key, with_stats=True, **kw)
        got.append(st)
        return y, aux

    moe.moe_ffn = counted
    try:
        with torch.no_grad():
            gpt.forward_with_aux(params, tokens[:1, :-1], cfg,
                                 key=rng.fold_in(key, 0))
    finally:
        moe.moe_ffn = real
    dropped = sum(int(st["dropped"]) for st in got)
    load = [int(sum(int(st["load"][e]) for st in got))
            for e in range(cfg.moe.num_experts)]
    n_assign = cfg.num_layers * (tokens.shape[1] - 1) * cfg.moe.top_k
    if len(got) != cfg.num_layers or dropped + sum(load) != n_assign:
        raise AssertionError(f"routing stats of {len(got)} layers: dropped "
                             f"{dropped} + kept {sum(load)} != {n_assign}")
    return {"layers": len(got), "tokens": tokens.shape[1] - 1,
            "capacity": moe.expert_capacity(tokens.shape[1] - 1, cfg.moe),
            "kept": sum(load), "dropped": dropped,
            "drop_rate": dropped / n_assign, "expert_load": load}


def moe_small_cfg(torch, gpt, moe, cf=1.25):
    """The small fp32 MoE model of the card-vs-CPU checks: head_dim 128,
    4 top-2 experts; at 4 slots C = 3, so batch-mates contend."""
    return gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                         num_heads=2, max_seq_len=256, dtype=torch.float32,
                         moe=moe.MoEConfig(num_experts=4, top_k=2,
                                           capacity_factor=cf))


def moe_small_serve(torch, serving, cfg, params, dev, layout, prompts, new,
                    block, **kw):
    """One small serve (``_small_server``'s geometry; graphed on the card
    unless ``_graphs=False``): (streams, dropped, load)."""
    srv = _small_server(serving, cfg, params, dev, layout, **kw)
    served = serve(torch, srv, prompts, new, block)[0]
    ls = srv.load_stats()
    srv.close()
    return served, ls["moe_dropped_tokens"], ls["moe_expert_load"]


def moe_small_vs_cpu(torch, gpt, G, serving, moe, moe_serving):
    """(a) The small fp32 MoE model, card against CPU: three prompts
    admitted and five joint-routing steps over four slots (one free) —
    logits within PATH_TOL, routing counters equal; then six requests
    served on both layouts by tick, ``tick_block(8)``, async dispatch and
    budgeted admission (``prefill_budget=16``), graphed and eager on the
    card, each equal to the same serve on the CPU — streams, drops and
    expert load; then the zero-router model at cf 0.5 (every token ties
    onto experts 0 and 1, C = 1 at 2 slots), graphed: the device drop
    counter equals the host-replayed schedule."""
    out = {}
    cfg = moe_small_cfg(torch, gpt, moe)
    cpu = gpt.init_params(cfg, seed=3, device="cpu")
    card = _to_card(cpu)
    V = cfg.vocab_size
    worst = 0.0
    caches = {d: G.init_cache(cfg, 4, 160, d) for d in ("cpu", "cuda")}
    stats = {d: moe_serving.moe_stats_init(4, d) for d in ("cpu", "cuda")}
    params = {"cpu": cpu, "cuda": card}
    rng = np.random.default_rng(0)
    lens = [5, 40, 100]
    for slot, n in enumerate(lens):
        toks = np.zeros((1, serving._pow2_bucket(n)), np.int64)
        toks[0, :n] = rng.integers(0, V, n)
        outs = {d: G.prefill_slot(params[d], caches[d],
                                  torch.from_numpy(toks).to(d), n, slot,
                                  cfg)[0] for d in params}
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max()
                    .item())
    act = np.array([True, True, True, False])
    pos = np.array(lens + [0], np.int32)
    for _ in range(5):
        tok = rng.integers(0, V, 4)
        outs = {d: moe_serving.moe_decode_step_batched(
            params[d], caches[d], torch.from_numpy(tok).to(d),
            torch.from_numpy(pos).to(d), torch.from_numpy(act).to(d),
            stats[d], cfg)[0] for d in params}
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max()
                    .item())
        pos[:3] += 1
    counted = {d: (int(s["dropped"]), s["load"].tolist())
               for d, s in stats.items()}
    log(f"  joint steps: max|logits card - cpu| {worst:.3g} (tol "
        f"{PATH_TOL}); (dropped, load) card {counted['cuda']}, cpu "
        f"{counted['cpu']}")
    if not worst <= PATH_TOL or counted["cuda"] != counted["cpu"]:
        raise AssertionError("MoE joint steps: the card disagrees with the "
                             "CPU")
    out["step_logits_gap"] = worst

    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, V, (n,), generator=gen).tolist()
               for n in (5, 40, 100, 17, 60, 9)]
    new = 8
    modes = (("tick", {}, None), ("block8", {}, 8),
             ("async", dict(async_dispatch=True), None),
             ("budgeted", dict(prefill_budget=16), None))
    served = {}
    for layout in ("contiguous", "paged"):
        for mode, kw, block in modes:
            ref = moe_small_serve(torch, serving, cfg, cpu, "cpu", layout,
                                  prompts, new, block, **kw)
            for way, extra in (("graph", {}), ("eager",
                                                dict(_graphs=False))):
                got = moe_small_serve(torch, serving, cfg, card, "cuda",
                                      layout, prompts, new, block, **kw,
                                      **extra)
                if got != ref:
                    raise AssertionError(
                        f"MoE {layout} {mode} {way}: card (streams, "
                        f"dropped, load) {got} vs the CPU's {ref}")
            served[f"{layout} {mode}"] = ref[1:]
    log(f"  served streams, drops and load card == CPU (graph and eager) "
        f"in 8 cases; (dropped, load) by case: {served}")
    out["served_cases"] = served

    zcfg = moe_small_cfg(torch, gpt, moe, cf=0.5)
    zero = gpt.init_params(zcfg, seed=5, device="cuda")
    zero["blocks"]["moe"]["router_w"].zero_()
    srv = serving.DecodeServer(zero, zcfg, max_batch=2, max_len=32)
    srv.warmup(prompt_lens=[2, 3])
    rids = [srv.submit([1, 2], max_new_tokens=4),
            srv.submit([3, 4, 5], max_new_tokens=4)]
    exp_dropped = exp_kept = 0
    while srv.pending():
        active = sum(1 for st in srv._slots.values()
                     if not st.get("admitting"))
        srv.tick()
        if active:
            exp_dropped += 2 * zcfg.num_layers * max(0, active - 1)
            exp_kept += zcfg.num_layers
    ls = srv.load_stats()
    srv.close()
    log(f"  zero router, cf 0.5: dropped {ls['moe_dropped_tokens']} (host "
        f"replay {exp_dropped}), load {ls['moe_expert_load']}")
    if exp_dropped <= 0 or ls["moe_dropped_tokens"] != exp_dropped \
            or ls["moe_expert_load"] != [exp_kept, exp_kept, 0, 0] \
            or not all(len(srv.result(r)) == 4 for r in rids):
        raise AssertionError(f"the device drop counter {ls} against the host "
                             f"replay {exp_dropped} dropped, {exp_kept} kept")
    out["zero_router"] = {"dropped": exp_dropped, "load": exp_kept}
    return out


def moe_parity_fp32(torch, gpt, moe, moe_serving, engine, wl):
    """(b) Full width in fp32 at the dropless cf = E / k (C >= B, so
    joint routing is solo routing), TF32 off: main's first
    MOE_PARITY_REQUESTS requests for MOE_PARITY_NEW tokens, graphed and
    warmed, on the main and paged geometries — the streams exactly
    ``dense_reference_greedy``'s (every expert for every token, a solo
    cache each), no drop counted, every tick one ``serving.moe_step``
    replay and every admission one of its graph's."""
    cfg = moe_config(gpt, moe, cf=MOE_E / MOE_K, dtype=torch.float32)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"weight_gb": _tree_bytes(params) / 1e9,
           "init_s": time.perf_counter() - t0}
    prompts = wl.main_prompts(cfg.vocab_size, 0)[:MOE_PARITY_REQUESTS]
    new = MOE_PARITY_NEW
    t0 = time.perf_counter()
    ref = [moe_serving.dense_reference_greedy(params, cfg, p, new, 512)
           for p in prompts]
    out["reference_s"] = time.perf_counter() - t0
    for path in ("main", "paged"):
        kw = dict(num_blocks=256) if path == "paged" else {}
        srv = wl.make_server(path, params, cfg, **kw)
        srv.warmup(prompt_lens=[len(p) for p in prompts])
        replays0 = replays_now(engine, srv, "serving.moe_step")
        served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
        graphed_serve(torch, engine, srv, ticks, replays0, len(prompts),
                      "serving.moe_step")
        dropped, load = srv._moe_snapshot()
        srv.close()
        out[path] = {"equal": served == ref, "dropped": dropped,
                     "load": load, "ticks": len(ticks),
                     "tick_ms_median": 1e3 * statistics.median(ticks)}
        log(f"  fp32 {path}: streams == dense_reference_greedy "
            f"{served == ref}, dropped {dropped}, load {load}, tick median "
            f"{out[path]['tick_ms_median']:.2f} ms")
        if served != ref or dropped:
            raise AssertionError(f"fp32 MoE {path}: {served} vs the "
                                 f"dense-eval reference {ref}, {dropped} "
                                 f"dropped")
    log(f"  weights {out['weight_gb']:.3f} GB fp32, the reference's solo "
        f"streams {out['reference_s']:.1f} s")
    del params
    engine.ENGINE.purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_forced_rows(torch, G, serving, moe_serving, params, cfg, prompts,
                    streams, slots):
    """The routed steps teacher-forced on ``streams`` (request r in slot
    ``slots[r]`` of an 8-slot cache, as the server placed it): each
    prompt admitted by ``prefill_slot``, then the joint step over the
    8 slots feeding each stream's tokens.  Returns (rows, counters):
    rows[r][i], the logits that chose token i of request r; counters,
    the joint steps' (dropped, load), as a server's ``_moe_snapshot``
    reads them (admission adds nothing to them)."""
    B = 8
    cache = G.init_cache(cfg, B, 512, "cuda")
    stats = moe_serving.moe_stats_init(cfg.moe.num_experts, "cuda")
    rows = {}
    for r, p in enumerate(prompts):
        toks = torch.zeros((1, serving._pow2_bucket(len(p), 512)),
                           dtype=torch.int64)
        toks[0, :len(p)] = torch.tensor(p)
        rows[r] = [G.prefill_slot(params, cache, toks.cuda(), len(p),
                                  slots[r], cfg)[0].float()]
    act = torch.zeros(B, dtype=torch.bool)
    act[slots] = True
    pos = torch.zeros(B, dtype=torch.int32)
    pos[slots] = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    tok = torch.zeros(B, dtype=torch.int64)
    for t in range(len(streams[0]) - 1):
        tok[slots] = torch.tensor([s[t] for s in streams])
        lg = moe_serving.moe_decode_step_batched(
            params, cache, tok.cuda(), pos.cuda(), act.cuda(), stats,
            cfg)[0]
        for r, b in enumerate(slots):
            rows[r].append(lg[b].float())
        pos[slots] += 1
    return rows, (int(stats["dropped"].item()),
                  [int(v) for v in stats["load"].tolist()])


def moe_hold(rows, got, ref, what):
    """``got`` against ``ref`` by the tie rule in a jointly routed batch:
    at the first step where any stream leaves ``ref``, each token that
    left must sit within TIE_TOL of the best logit of its row in the
    teacher-forced routed context of ``ref`` or of ``got`` (``rows``:
    the two agree up to that step).  Past that step
    batch-mates route against another context, so the streams are not
    compared further.  Returns (streams equal throughout, the first
    divergence (step, {request: gap}) or None)."""
    steps = [next((i for i, (a, b) in enumerate(zip(g, f)) if a != b), None)
             for g, f in zip(got, ref)]
    first = min((i for i in steps if i is not None), default=None)
    if first is None:
        return len(got), None
    gaps = {}
    for r, i in enumerate(steps):
        if i == first:
            row = rows[r][i]
            gaps[r] = (row.max() - row[got[r][i]]).item()
    log(f"  {what}: the streams first leave the eager ones at step {first} "
        f"(requests {sorted(gaps)}, logit gaps {gaps}; tie tolerance "
        f"{TIE_TOL})")
    if not all(g <= TIE_TOL for g in gaps.values()):
        raise AssertionError(f"{what}: left the reference at step {first} "
                             f"off a tie: gaps {gaps}")
    return sum(i is None for i in steps), (first, gaps)


def dense_eval_graph(torch, G, engine, moe_serving, params, cfg, B, rows):
    """``dense_eval_decode_step`` over a B-slot cache of ``rows`` rows,
    captured as one CUDA graph (fed tok [B] and per-slot pos [B]; returns
    its output tuple).  Returns (the step, its cache)."""
    cache = G.init_cache(cfg, B, rows, "cuda")

    def body(p, c, tok, pos):
        return (moe_serving.dense_eval_decode_step(p, c, tok, pos, cfg)[0],)

    return engine._Graph(body, engine.Binding(params, cache),
                         "moe.dense_eval_step"), cache


def dense_forced_share(torch, step, prompts, streams):
    """Teacher-force prompt + stream through the dense-eval step, every
    request in its own slot at its own positions: the share of served
    tokens within TIE_TOL of the dense-eval best logit, and the largest
    gap (a reading: below the dropless capacity a routed stream may leave
    the dense evaluation wherever a drop moved a logit)."""
    seqs = [p + s for p, s in zip(prompts, streams)]
    B = len(seqs)
    within = total = 0
    worst = 0.0
    for t in range(max(len(q) for q in seqs) - 1):
        at = [min(t, len(q) - 2) for q in seqs]
        tok = torch.tensor([q[i] for q, i in zip(seqs, at)])
        pos = torch.tensor(at, dtype=torch.int32)
        nxt = torch.tensor([q[i + 1] for q, i in zip(seqs, at)]).cuda()
        (lg,) = step(tok, pos)
        gap = (lg.max(-1).values - lg.gather(1, nxt[:, None])[:, 0]).cpu()
        for b in range(B):
            if at[b] == t and t + 1 >= len(prompts[b]):
                total += 1
                within += bool(gap[b] <= TIE_TOL)
                worst = max(worst, gap[b].item())
    return within / total, worst


def dense_eval_arm(torch, G, serving, step, cache, params, cfg, prompts,
                   new):
    """The dense-eval arm (the JAX bench's ``vs_dense_eval``): the prompts
    admitted into the step's cache by the routed ``prefill_slot`` (outside
    the timing), then ``new - 1`` graphed dense-eval steps over all slots
    at their own positions, each fetching its argmax as a tick does.
    Returns decode tokens/s."""
    B = len(prompts)
    first = []
    for b, p in enumerate(prompts):
        toks = torch.zeros((1, serving._pow2_bucket(len(p), 512)),
                           dtype=torch.int64)
        toks[0, :len(p)] = torch.tensor(p)
        first.append(int(G.prefill_slot(params, cache, toks.cuda(), len(p),
                                        b, cfg)[0].argmax()))
    tok = torch.tensor(first)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(new - 1):
        (lg,) = step(tok, pos)
        tok = torch.argmax(lg, dim=-1).cpu()
        pos += 1
    wall = time.perf_counter() - t0
    return B * (new - 1) / wall


def moe_profile(torch, wl, params, cfg, prompts, dstep):
    """Device time by kernel family (``profile_serving.summarize``, the
    routing's sorts apart) of 8 graphed ticks of a warmed main-geometry
    MoE server with every slot decoding, and of 8 replays of the
    dense-eval step ``dstep`` at the prompts' positions; torch.profiler's
    walls carry its own host cost, so read the device times."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fams = (("routing_sort", ("sort", "radix")),) + wl.FAMILIES
    srv = wl.make_server("main", params, cfg)
    srv.warmup(prompt_lens=[len(p) for p in prompts])
    for p in prompts:
        srv.submit(p, max_new_tokens=wl.NEW)
    for _ in range(4):
        srv.tick()
    out = {}
    tok = torch.zeros(len(prompts), dtype=torch.int64)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for name, step in (("routed tick", srv.tick),
                       ("dense-eval step", lambda: dstep(tok, pos)[0]
                        .argmax(-1).cpu())):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = r = wl.summarize(torch, prof, wall, 8, fams)
        dev = ("not measured" if r["device_ms"] is None
               else f"{r['device_ms']:.3f} ms")
        log(f"  {name}, profiled: device {dev}, "
            f"{r['launches']:.0f} launches, by family "
            f"{json.dumps({k: round(v, 4) for k, v in r['device_ms_by_family'].items()})}")
    while srv.pending():
        srv.tick()
    srv.close()
    return out


def moe_serve_bf16(torch, gpt, G, serving, moe, moe_serving, engine, ks, wl,
                   da):
    """(c) The full-width bf16 MoE model at cf 1.25 serving main's 8
    requests (64 new tokens each) on the main and paged geometries: eager
    first (the reference streams), then graphed and warmed
    (:func:`tree_serve` on ``serving.moe_step`` with
    :func:`moe_step_flops`): :func:`route_gates`, the graphed streams held
    to the eager ones by :func:`moe_hold`, the feed's MFU and bandwidth
    use in range, the routing totals and the drop rate, the teacher-forced
    dense-eval share; then the dense-eval arm on the same weights.
    Returns (stats, launches of the two gated serves)."""
    cfg = moe_config(gpt, moe)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"model": f"gpt_1p3b widths, {MOE_E} experts top-{MOE_K}, cf "
                    f"{MOE_CF}",
           "params": sum(t.numel() for _, t in _leaves(params)),
           "weight_bytes": _tree_bytes(params),
           "init_s": time.perf_counter() - t0}
    assert params["blocks"]["moe"]["router_w"].dtype == torch.float32
    log(f"  {out['model']}: {out['params']} params, weights "
        f"{out['weight_bytes'] / 1e9:.3f} GB (bf16, the router fp32)")
    prompts, new = wl.main_prompts(cfg.vocab_size, 0), wl.NEW
    slots = [7 - r for r in range(len(prompts))]
    launches = {}
    for path in ("main", "paged"):
        kw = dict(num_blocks=256) if path == "paged" else {}
        gc.collect()
        torch.cuda.empty_cache()
        eager = wl.make_server(path, params, cfg, _graphs=False, **kw)
        ref, _, eticks, ewall = serve(torch, eager, prompts, new)
        eager.close()
        del eager
        served, st = tree_serve(torch, engine, wl, ks, path, cfg, params,
                                prompts, new, step="serving.moe_step",
                                flops=moe_step_flops(cfg, 8, 512), **kw)
        route_gates(cfg, path, st, da)
        st["served"] = served
        for n, v in st["launches"].items():
            launches[n] = launches.get(n, 0) + v
        step = st["feed_step"]
        if not (step["mfu"] and 0 < step["mfu"] < 1) \
                or not step["hbm_bw_util"] \
                or step["hbm_bw_util"] > HBM_UTIL_CAP:
            raise AssertionError(f"MoE {path}: serving.moe_step's feed "
                                 f"{step}")
        rows, _ = moe_forced_rows(torch, G, serving, moe_serving, params,
                                  cfg, prompts, ref, slots)
        st["eager_equal"], st["eager_divergence"] = moe_hold(
            rows, served, ref, f"MoE {path} graph vs eager")
        del rows
        kept = sum(st["moe_expert_load"])
        st["drop_rate"] = st["moe_dropped_tokens"] / max(
            1, st["moe_dropped_tokens"] + kept)
        st["eager_tick_ms_median"] = 1e3 * statistics.median(eticks)
        st["eager_tokens_per_s"] = sum(len(s) for s in ref) / ewall
        out[path] = st
        log(f"  MoE {path}: tokens/s {st['tokens_per_s']:.1f} (eager "
            f"{st['eager_tokens_per_s']:.1f}), tick ms mean "
            f"{st['tick_ms_mean']:.3f} median {st['tick_ms_median']:.3f} "
            f"(eager median {st['eager_tick_ms_median']:.2f}), admission "
            f"{st['admission_ms']:.1f} ms, reserved {st['reserved_gb']:.4f} "
            f"GB ({st['graph_pools_gb']:.4f} in graph pools), weights "
            f"{out['weight_bytes']} bytes; moe_dropped_tokens "
            f"{st['moe_dropped_tokens']}, drop rate {st['drop_rate']:.4f}, "
            f"moe_expert_load {st['moe_expert_load']}; "
            f"{st['eager_equal']} of {len(prompts)} streams equal to eager "
            f"throughout; launches "
            f"{ {k: v for k, v in st['launches'].items() if v} }, tick body "
            f"{ {k: v for k, v in st['tick_launches'].items() if v} }, "
            f"tensor-core {({k: v for k, v in st['tc_launches'].items() if v})}")
        log(f"    serving.moe_step {json.dumps(step)}")

    gc.collect()
    torch.cuda.empty_cache()
    dstep, dcache = dense_eval_graph(torch, G, engine, moe_serving, params,
                                     cfg, len(prompts), 512)
    share, worst = dense_forced_share(torch, dstep,
                                      prompts, out["main"]["served"])
    dense_tps = dense_eval_arm(torch, G, serving, dstep, dcache, params, cfg,
                               prompts, new)
    routed_tps = len(prompts) * 1e3 / out["main"]["tick_ms_mean"]
    out["dense_eval"] = {"forced_share_within_tie": share,
                         "forced_worst_gap": worst,
                         "decode_tokens_per_s": dense_tps,
                         "routed_decode_tokens_per_s": routed_tps,
                         "vs_dense_eval": routed_tps / dense_tps}
    log(f"  dense-eval arm (every expert for every token, graphed, 8 slots "
        f"at their own positions): decode tokens/s {dense_tps:.1f} against "
        f"the routed serve's {routed_tps:.1f} (vs_dense_eval "
        f"{routed_tps / dense_tps:.3f}); the main serve's tokens within "
        f"{TIE_TOL} of the teacher-forced dense-eval best: {share:.4f} "
        f"(largest gap {worst:.4g}; a reading, not a gate)")
    out["profile"] = moe_profile(torch, wl, params, cfg, prompts, dstep)
    dstep.release()
    del dstep, dcache, params
    engine.ENGINE.purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def moe_phase(torch, gpt, G, serving, engine, ks, wl, da):
    """[MoE serving] (a) :func:`moe_small_vs_cpu`, (b)
    :func:`moe_parity_fp32`, (c) :func:`moe_serve_bf16`; the launches
    are those of (c)'s two gated serves.  Returns (stats, launches)."""
    from paddle_tpu_torch.text import moe, moe_serving

    t0 = time.perf_counter()
    small = moe_small_vs_cpu(torch, gpt, G, serving, moe, moe_serving)
    parity = moe_parity_fp32(torch, gpt, moe, moe_serving, engine, wl)
    bf16, launches = moe_serve_bf16(torch, gpt, G, serving, moe,
                                    moe_serving, engine, ks, wl, da)
    stats = {"small": small, "fp32_parity": parity,
             "bf16": {k: ({n: x for n, x in v.items() if n not in (
                 "launches", "tc_launches", "tick_launches", "served",
                 "admission_calls")} if isinstance(v, dict) else v)
                 for k, v in bf16.items()},
             "tc_launches": {n: sum(bf16[p]["tc_launches"][n]
                                    for p in ("main", "paged"))
                             for n in bf16["main"]["tc_launches"]},
             "tick_launches": {n: sum(bf16[p]["tick_launches"][n]
                                      for p in ("main", "paged"))
                               for n in ("decode_attention",
                                         "paged_decode_attention")},
             "phase_s": time.perf_counter() - t0}
    log(f"[the MoE phase: {stats['phase_s']:.1f} s of command time]")
    return stats, launches


# --------------------------------------------------------------------------
# multi-tenant serving: LoRA adapter pools, constrained decoding, LoRA
# training and evaluation
# --------------------------------------------------------------------------

ADAPTER_RANK = 8                 # the 1.3B pool's rank (default targets)
ADAPTER_N = 4                    # adapters in the 1.3B pool (ids 1-4)
ADAPTER_B_STD = 0.1              # the 1.3B adapters' b: N(0, 1) x this
SMALL_B_STD = 0.3                # the small models' b (bench.py:1863)
JSON_SCHEMA = {"type": "object",
               "properties": {"ok": {"type": "boolean"},
                              "tag": {"enum": ["a", "b"]}}}
EVAL_TOL = 0.02                  # nats: bf16 nll, forward vs decode path
EVAL_INT8_REL = 0.05             # int8-KV cached perplexity, relative
JSON_NEW = 32                    # new tokens a constrained request may
                                 # take (the schema's texts are <= 22)
LORA_LR = 2e-3
LORA_BATCH = 4                   # the LoRA rung: 4 x 2048 tokens a step


def make_adapters(torch, lora, params, cfg, n, rank, b_std, targets=None):
    """``n`` adapter sub-trees over ``params``: ``lora_init``'s ``a``
    under key i + 1 and ``b`` drawn as ``b_std`` x N(0, 1) (a torch
    generator seeded 1000 + i, on the params' device), so each bites."""
    out = []
    kw = {} if targets is None else dict(targets=targets)
    for i in range(n):
        ad = lora.split_lora(lora.lora_init(params, cfg, rank=rank,
                                            key=i + 1, **kw))[1]
        dev = next(iter(ad.values())).device
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        out.append({k: (b_std * torch.randn(v.shape, generator=gen,
                                            device=dev)
                        if k.endswith("_lora_b") else v)
                    for k, v in ad.items()})
    return out


def adapter_step_flops(cfg, batch, window, pool):
    """:func:`step_flops` plus the pool's per-slot rank-r terms: 2 · batch
    · rank · (in + out) a targeted [k, in, out] matrix, k of them a layer
    (the gather moves bytes, no FLOPs)."""
    extra = 0
    for t in pool.targets:
        shp = pool.stacks()[t + "_lora_a"].shape   # [A, L, (k,) in, r]
        k = shp[2] if len(shp) == 5 else 1
        out = pool.stacks()[t + "_lora_b"].shape[-1]
        extra += 2 * batch * pool.rank * (shp[-2] + out) * k * shp[1]
    return step_flops(cfg, batch, window) + extra


def drain(srv, jobs, new, block=None):
    """Submit ``jobs`` ((prompt, submit options) pairs) and tick (or
    ``tick_block(block)``) until drained, on any device: the streams."""
    rids = [srv.submit(p, max_new_tokens=new, **kw) for p, kw in jobs]
    for _ in range(20 * new):
        if not srv.pending():
            break
        srv.tick_block(block) if block else srv.tick()
    if srv.pending():
        raise AssertionError("server did not drain")
    return [[int(t) for t in srv.result(r)] for r in rids]


def solo_greedy(torch, G, params, cfg, prompt, new, dev):
    """One prompt's greedy stream through ``generate.decode_step``,
    position by position, on ``dev``."""
    cache = G.init_cache(cfg, 1, cfg.max_seq_len, dev)
    out, tok = [], None
    for pos in range(len(prompt) + new - 1):
        cur = prompt[pos] if pos < len(prompt) else tok
        logits, cache = G.decode_step(params, cache,
                                      torch.tensor([cur], device=dev), pos,
                                      cfg)
        if pos >= len(prompt) - 1:
            tok = int(logits[0].argmax())
            out.append(tok)
    return out


def _adapter_logit_gap(torch, G, A, cfg, cpu, card, pools, paged):
    """Admission of three slots under ids 0, 1, 2, then four adapter
    decode steps and a K = 4 verify with mixed ids, on the card and on the
    CPU from the same weights and pools: the largest |logits card - cpu|."""
    rng = np.random.default_rng(1)
    lay = dict(layout="paged", block_size=16, num_blocks=30) if paged else {}
    caches = {dev: G.init_cache(cfg, 3, 160, dev, **lay)
              for dev in ("cpu", "cuda")}
    if paged:
        tables = torch.full(tuple(caches["cpu"]["tables"].shape), -1,
                            dtype=torch.int32)
        tables[:, :10] = torch.from_numpy(
            rng.permutation(30).astype(np.int32).reshape(3, 10))
        for c in caches.values():
            c["tables"].copy_(tables)
    params = {"cpu": cpu, "cuda": card}
    lens, worst = [5, 40, 100], 0.0
    for slot, n in enumerate(lens):
        toks = np.zeros((1, 128), np.int64)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        outs = {}
        for dev in ("cpu", "cuda"):
            t = torch.from_numpy(toks).to(dev)
            if paged:
                outs[dev], _ = A.adapter_paged_prefill_chunk(
                    params[dev], caches[dev], pools[dev].stacks(), slot, t,
                    0, n, slot, cfg)
            else:
                outs[dev], _ = A.adapter_prefill_slot(
                    params[dev], caches[dev], pools[dev].stacks(), slot, t,
                    n, slot, cfg)
        worst = max(worst, (outs["cuda"].cpu() - outs["cpu"]).abs().max()
                    .item())
    ids = np.array([0, 1, 2])
    pos = np.array(lens, np.int32)
    for step in range(5):
        outs = {}
        verify = step == 4
        tok = rng.integers(0, cfg.vocab_size, (3, 4) if verify else 3)
        for dev in ("cpu", "cuda"):
            fn = (A.adapter_spec_verify_batched if verify
                  else A.adapter_decode_step_batched)
            outs[dev], _ = fn(params[dev], caches[dev], pools[dev].stacks(),
                              torch.from_numpy(ids).to(dev),
                              torch.from_numpy(tok).to(dev),
                              torch.from_numpy(pos).to(dev), cfg)
        d = (outs["cuda"].cpu() - outs["cpu"]).abs().max().item()
        assert np.isfinite(d)
        worst = max(worst, d)
        pos = pos + 1
    return worst


def adapters_small_vs_cpu(torch, gpt, G, serving, A, lora, engine):
    """(a) A small fp32 model (TF32 off) with a 3-adapter pool, card
    against CPU: the adapter steps' logits with mixed ids within PATH_TOL
    (contiguous and paged); the streams of tick, tick_block(8), async and
    budgeted admission, both layouts, graphed and eager, equal to the CPU
    serve's, and each adapter's streams to its merged tree's solo greedy
    decode (by the PATH_TOL tie rule); a token-set and a JSON-schema
    stream (vocab: token id = char code) equal to the CPU's, the JSON
    parsing to the schema's shape; linear speculation under the pool equal
    to the plain pool serve; a constrained tree serve equal to the plain
    constrained serve with no spec fallback.  Returns a dict of results."""
    from paddle_tpu_torch import telemetry as tl

    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=torch.float32)
    cpu = gpt.init_params(cfg, seed=11, device="cpu")
    card = _to_card(cpu)
    ads = make_adapters(torch, lora, cpu, cfg, 3, 4, SMALL_B_STD)
    pools = {}
    for dev, p in (("cpu", cpu), ("cuda", card)):
        pools[dev] = A.AdapterPool(p, cfg, rank=4, max_adapters=3)
        for i, ad in enumerate(ads):
            pools[dev].register(f"ad-{i + 1}",
                                {k: v.to(dev) for k, v in ad.items()})
    out = {"logit_gap": {}}
    for paged in (False, True):
        gap = _adapter_logit_gap(torch, G, A, cfg, cpu, card, pools, paged)
        out["logit_gap"]["paged" if paged else "contiguous"] = gap
        if not gap <= PATH_TOL:
            raise AssertionError(f"adapter step logits card vs CPU {gap}")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (5, 40, 100, 17)]
    jobs = [(p, {"adapter": None if i == 0 else f"ad-{i}"})
            for i, p in enumerate(prompts)]
    new = 12
    merged = [cpu] + [lora.merge_lora(lora.join_lora(cpu, ad))
                      for ad in ads]
    solo = [solo_greedy(torch, G, merged[i], cfg, p, new, "cpu")
            for i, p in enumerate(prompts)]
    merged_card = [card] + [_to_card(m) for m in merged[1:]]
    ways = (("tick", {}, None), ("block8", {}, 8),
            ("async", dict(async_dispatch=True), None),
            ("budget", dict(prefill_budget=16), None))
    paged_kw = dict(layout="paged", block_size=16, num_blocks=48)
    served = {}
    for lay, lkw in (("contiguous", {}), ("paged", paged_kw)):
        for way, wkw, block in ways:
            ref = drain(serving.DecodeServer(
                cpu, cfg, max_batch=4, max_len=160, device="cpu",
                adapter_pool=pools["cpu"], **lkw, **wkw), jobs, new, block)
            for graphs in (True, False):
                srv = serving.DecodeServer(
                    card, cfg, max_batch=4, max_len=160, device="cuda",
                    adapter_pool=pools["cuda"], _graphs=graphs, **lkw, **wkw)
                got = drain(srv, jobs, new, block)
                if graphs and not engine.ENGINE.graphs(srv._bind):
                    raise AssertionError(f"{lay} {way}: no graph captured")
                srv.close()
                what = f"{lay} {way} {'graph' if graphs else 'eager'}"
                for r in range(len(jobs)):
                    check_tokens(torch, gpt, merged_card[r], cfg, prompts[r],
                                 got[r], ref[r], f"{what} request {r} vs "
                                 f"the CPU serve", tol=PATH_TOL)
                    check_tokens(torch, gpt, merged_card[r], cfg, prompts[r],
                                 got[r], solo[r], f"{what} request {r} vs "
                                 f"its merged solo decode", tol=PATH_TOL)
                served[what] = got == ref
    out["streams_equal_cpu"] = served
    # constrained: a token set and the JSON schema over token id = char
    vocab = [chr(i) for i in range(cfg.vocab_size)]
    spec = A.JsonSchemaConstraint(JSON_SCHEMA, vocab)
    allowed = [3, 7, 11, 19, 40]
    cjobs = [(prompts[0], {"constraint": allowed}),
             (prompts[1], {"constraint": spec, "adapter": "ad-1"}),
             (prompts[2], {"constraint": spec})]
    tl.reset()
    got = {dev: drain(serving.DecodeServer(
        p, cfg, max_batch=4, max_len=160, device=dev,
        adapter_pool=pools[dev]), cjobs, 30)
        for dev, p in (("cpu", cpu), ("cuda", card))}
    if got["cuda"] != got["cpu"]:
        raise AssertionError(f"constrained streams card {got['cuda']} vs "
                             f"cpu {got['cpu']}")
    assert all(t in allowed for t in got["cuda"][0])
    docs = [json.loads("".join(vocab[t] for t in s))
            for s in got["cuda"][1:]]
    for doc in docs:
        if set(doc) != {"ok", "tag"} or not isinstance(doc["ok"], bool) \
                or doc["tag"] not in ("a", "b"):
            raise AssertionError(f"JSON stream {doc} is not the schema's")
    out["json"] = ["".join(vocab[t] for t in s) for s in got["cuda"][1:]]
    out["masked_tokens"] = tl.counter("constraint.masked_tokens")
    assert out["masked_tokens"] > 0
    # linear speculation under the pool: the plain pool serve's streams
    plain = drain(serving.DecodeServer(card, cfg, max_batch=4, max_len=160,
                                       device="cuda",
                                       adapter_pool=pools["cuda"]),
                  jobs, new)
    spec_srv = serving.DecodeServer(card, cfg, max_batch=4, max_len=160,
                                    device="cuda",
                                    adapter_pool=pools["cuda"], spec_k=4,
                                    draft_cfg=cfg, draft_params=card)
    got = drain(spec_srv, jobs, new)
    rounds = spec_srv._spec_rounds
    spec_srv.close()
    if got != plain or not rounds:
        raise AssertionError(f"spec under a pool: {got} vs {plain}, "
                             f"{rounds} rounds")
    out["spec_rounds"] = rounds
    # a constrained tree serve against the plain constrained serve
    tjobs = [(prompts[0], {"constraint": allowed}),
             (prompts[3], {"constraint": allowed})]
    plain = drain(serving.DecodeServer(card, cfg, max_batch=4, max_len=160,
                                       device="cuda"), tjobs, new)
    tl.reset()
    tree = serving.DecodeServer(card, cfg, max_batch=4, max_len=160,
                                device="cuda", spec_tree=4, draft_cfg=cfg,
                                draft_params=card)
    got = drain(tree, tjobs, new)
    tree.close()
    fb = tl.counter("constraint.spec_fallbacks")
    tr_rounds = tl.counter("spec.tree_rounds")
    if got != plain or fb or not tr_rounds:
        raise AssertionError(f"constrained tree serve {got} vs {plain}, "
                             f"{fb} spec fallbacks, {tr_rounds} rounds")
    out["tree_rounds"], out["tree_spec_fallbacks"] = tr_rounds, fb
    engine.ENGINE.purge(cfg)
    return out


def adapter_jobs(prompts, n_ids):
    """Main's requests spread over adapter ids 0..n_ids - 1 (request r
    under id r % n_ids; id 0 the base model)."""
    return [(p, {"adapter": None if r % n_ids == 0 else f"ad-{r % n_ids}"})
            for r, p in enumerate(prompts)]


def adapter_serve_1p3b(torch, gpt, serving, engine, ks, wl, A, lora, path,
                       cfg, params, pool, ads):
    """(b) One layout of GPT-1.3B (bf16) under the pool: a pool-less
    graphed serve of main's (or paged's) 8 requests, then the pool's
    eager serve and its graphed, warmed serve of the same requests over
    ids 0-4 (counted: every tick one ``serving.adapter_step`` replay, no
    capture after warmup, every decode launch on the tick body, every
    admission on its tensor-core body), then a register after warmup.
    Gates: each adapted stream within TIE_TOL of its merged tree's best
    at every token (teacher-forced), the graphed streams the eager ones by
    the tie rule, id 0 the pool-less server's exactly; the re-registered
    adapter's next streams changed, on its new merged tree, with no build.
    Returns (stats, launches)."""
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.ops.decode_attention import R_TC

    prompts = (wl.main_prompts(cfg.vocab_size, 0) if path == "main"
               else wl.paged_prompts(cfg.vocab_size, 0))
    lens = [len(p) for p in prompts]
    new, L = wl.NEW, cfg.num_layers
    jobs = adapter_jobs(prompts, ADAPTER_N + 1)

    def make(**kw):
        return wl.make_server(path, params, cfg, **kw)

    def timed(srv, jobs_, warm=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rids = [srv.submit(p, max_new_tokens=new, **kw) for p, kw in jobs_]
        t_admit = time.perf_counter() - t0
        ticks = []
        while srv.pending():
            t1 = time.perf_counter()
            srv.tick()
            ticks.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [[int(t) for t in srv.result(r)] for r in rids]
        return got, way_stats(torch, engine, srv, got, t_admit, ticks, wall,
                              torch.cuda.max_memory_allocated(), warm or {}), \
            ticks

    plain_srv = make()
    warm = plain_srv.warmup(prompt_lens=lens)
    plain, plain_stats, _ = timed(plain_srv, [(p, {}) for p in prompts],
                                  warm)
    plain_srv.close()
    eager_srv = make(adapter_pool=pool, _graphs=False)
    eager, eager_stats, _ = timed(eager_srv, jobs)
    eager_srv.close()
    srv = make(adapter_pool=pool)
    since = time.time()
    warm = srv.warmup(prompt_lens=lens)
    replays0 = replays_now(engine, srv, "serving.adapter_step")
    builds0 = len(tl.compile_log())
    chunk_calls = []
    get = engine.ENGINE.get
    dec = ks["paged_decode_attention"]

    def counted_get(kind, spec):
        # each paged admission chunk (a replay), read from its feeds
        fn = get(kind, spec)
        if kind != "adapter_paged_prefill":
            return fn

        def counted(aid, tokens, pos0, length, slot):
            before = dec.tc_launches
            o = fn(aid, tokens, pos0, length, slot)
            chunk_calls.append((int(pos0), int(length), tokens.shape[1],
                                dec.tc_launches - before))
            return o
        return counted

    engine.ENGINE.get = counted_get
    try:
        zero_counts(ks)
        got, stats, ticks = timed(srv, jobs, warm)
        launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    finally:
        del engine.ENGINE.get
    admissions = len(chunk_calls) if path == "paged" else len(prompts)
    n_graphs = graphed_serve(torch, engine, srv, ticks, replays0, admissions,
                             step="serving.adapter_step")
    if len(tl.compile_log()) != builds0:
        raise AssertionError(f"{path}: the pool serve built steps after "
                             f"warmup: {tl.compile_log()[builds0:]}")
    # adapted prompts neither adopt nor index prefix rows: on the paged
    # geometry the pool runs dry, and the OOM ladder's counts show it
    pressure = {k: v for k, v in srv.stats().items()
                if k.startswith("resilience.")}
    load = srv.load_stats()
    if path == "main":
        assert launches["flash_attention_fwd"] == L * len(prompts), launches
        assert launches["decode_attention"] == L * len(ticks), launches
        assert launches["paged_decode_attention"] == 0, launches
        assert tc["flash_attention_fwd"] == launches["flash_attention_fwd"]
        assert tick["decode_attention"] == launches["decode_attention"]
    else:
        assert launches["paged_decode_attention"] == L * (
            len(ticks) + len(chunk_calls)), launches
        assert launches["decode_attention"] == 0, launches
        assert launches["flash_attention_fwd"] == 0, launches
        for _, _, C, added in chunk_calls:
            assert added == L * (C >= R_TC), chunk_calls
        narrow = sum(c[2] < R_TC for c in chunk_calls)
        assert tick["paged_decode_attention"] == L * (len(ticks) + narrow), (
            tick, chunk_calls)
    if not any(launches.values()):
        raise AssertionError(f"no kernel of the path ran: {launches}")
    feed = feed_gates(tl, cfg, f"{path} adapter graph serve", since,
                      step="serving.adapter_step",
                      want=adapter_step_flops(cfg, 8, 512, pool))
    # the streams: id 0 the pool-less server's exactly; the rest within
    # TIE_TOL of their merged tree's best at every token; graph vs eager
    ids = [r % (ADAPTER_N + 1) for r in range(len(prompts))]
    for r, i in enumerate(ids):
        if i == 0 and got[r] != plain[r]:
            raise AssertionError(f"{path} request {r} (id 0) differs from "
                                 f"the pool-less server's stream")
    gaps = {}
    for i in range(1, ADAPTER_N + 1):
        merged = lora.merge_lora(lora.join_lora(params, ads[i - 1]))
        for r in (r for r, j in enumerate(ids) if j == i):
            gaps[r] = forced_gap(torch, gpt, merged, cfg, prompts[r], got[r])
            check_tokens(torch, gpt, merged, cfg, prompts[r], got[r],
                         eager[r], f"{path} adapter request {r} graph vs "
                         f"eager")
        del merged
        gc.collect()
    if max(gaps.values()) > TIE_TOL:
        raise AssertionError(f"{path}: adapted tokens off their merged "
                             f"tree's best by {gaps}")
    changed = sum(got[r] != plain[r] for r, i in enumerate(ids) if i)
    log(f"  {path} adapter graph serve: {changed} of "
        f"{sum(1 for i in ids if i)} adapted streams differ from the base "
        f"model's; forced gaps {json.dumps(gaps)}")
    # a register after warmup: a row write, no capture; the next serve of
    # that name reads the new adapter
    graphs0 = len(engine.ENGINE.graphs(srv._bind))
    fresh = make_adapters(torch, lora, params, cfg, ADAPTER_N + 1,
                          ADAPTER_RANK, ADAPTER_B_STD)[-1]
    pool.register("ad-2", fresh)
    again_jobs = [(prompts[r], {"adapter": "ad-2"})
                  for r, i in enumerate(ids) if i == 2]
    again = drain(srv, again_jobs, new)
    if len(engine.ENGINE.graphs(srv._bind)) != graphs0 \
            or len(tl.compile_log()) != builds0:
        raise AssertionError("a register after warmup built a step")
    merged = lora.merge_lora(lora.join_lora(params, fresh))
    reg_gaps = [forced_gap(torch, gpt, merged, cfg, p, s)
                for (p, _), s in zip(again_jobs, again)]
    del merged
    before = [got[r] for r, i in enumerate(ids) if i == 2]
    if max(reg_gaps) > TIE_TOL or again == before:
        raise AssertionError(f"after the register: gaps {reg_gaps}, streams "
                             f"changed {again != before}")
    pool.register("ad-2", ads[1])
    srv.close()
    stats.update(
        layout=path, graphs=n_graphs, launches=launches, tc_launches=tc,
        tick_launches=tick, forced_gaps=gaps, adapted_changed=changed,
        register_gaps=reg_gaps, stack_bytes=_tree_bytes(pool.stacks()),
        eager=eager_stats, plain=plain_stats, device_feed=feed,
        admission_chunks=chunk_calls, resilience=pressure,
        adapters_active=load["adapters_active"],
        prefix_hit_rate=load.get("prefix_hit_rate"))
    log(f"  {path} under the pool (graph / eager / pool-less graph): "
        f"tokens/s {stats['tokens_per_s']:.1f} / "
        f"{eager_stats['tokens_per_s']:.1f} / "
        f"{plain_stats['tokens_per_s']:.1f}; tick ms mean "
        f"{stats['tick_ms_mean']:.3f} / {eager_stats['tick_ms_mean']:.3f} / "
        f"{plain_stats['tick_ms_mean']:.3f}, median "
        f"{stats['tick_ms_median']:.3f} / "
        f"{eager_stats['tick_ms_median']:.3f} / "
        f"{plain_stats['tick_ms_median']:.3f}; admission ms "
        f"{stats['admission_ms']:.1f} / {eager_stats['admission_ms']:.1f} / "
        f"{plain_stats['admission_ms']:.1f}; reserved GB "
        f"{stats['reserved_gb']:.4f} / {eager_stats['reserved_gb']:.4f} / "
        f"{plain_stats['reserved_gb']:.4f} (the stacks "
        f"{_tree_bytes(pool.stacks()) / 1e9:.4f} GB); {n_graphs} graphs; "
        f"{len(ticks)} ticks against the pool-less {plain_stats['calls']}; "
        f"resilience {json.dumps(pressure)}")
    return stats, launches


def constrained_1p3b(torch, gpt, serving, engine, ks, wl, A, cfg, params):
    """(c) GPT-1.3B (bf16) without a pool: main's 8 prompts under the
    JSON schema (vocab: token id = char code), greedy and at temperature
    1, on a graphed server warmed with ``constrained=True`` — every output
    parses to the schema's shape, every tick one ``serving.masked_step``
    replay, ``constraint.masked_tokens`` counted — beside a plain serve;
    then an async server's constrained serve, which drains to synchronous
    ticks (``constraint.sync_fallbacks``).  Returns (stats, launches)."""
    from paddle_tpu_torch import telemetry as tl

    prompts = wl.main_prompts(cfg.vocab_size, 0)
    lens = [len(p) for p in prompts]
    vocab = [chr(i) for i in range(cfg.vocab_size)]
    t0 = time.perf_counter()
    spec = A.JsonSchemaConstraint(JSON_SCHEMA, vocab)
    # the token table of every automaton state, built before the serves
    # time their ticks (the lazy tables are the spec's, shared by them)
    machine = spec._machine
    seen, todo = set(), [machine.rx.start_state]
    while todo:
        st = todo.pop()
        if st not in seen:
            seen.add(st)
            todo.extend(machine.table(st)[1].values())
    compile_s = time.perf_counter() - t0
    srv = wl.make_server("main", params, cfg)
    warm = srv.warmup(prompt_lens=lens, sample=True, constrained=True)
    out = {"spec_compile_s": compile_s, "dfa_states": len(seen)}
    launches = None
    for temp in (0.0, 1.0):
        tl.reset()
        r0 = step_replays(engine, srv, "serving.masked_step")
        mask_s = []
        build = srv._mask_array

        def timed_mask():
            # the host's mask build a tick, timed from outside the server
            t1 = time.perf_counter()
            m = build()
            mask_s.append(time.perf_counter() - t1)
            return m

        srv._mask_array = timed_mask
        zero_counts(ks)
        torch.cuda.synchronize()
        served, t_admit, ticks, wall = serve(torch, srv, prompts, JSON_NEW,
                                             constraint=spec,
                                             temperature=temp)
        if launches is None:
            launches = launch_counts(ks)
            tick = tick_counts(ks)
            if tick["decode_attention"] != launches["decode_attention"] \
                    or not launches["decode_attention"]:
                raise AssertionError(f"constrained decode launches "
                                     f"{launches}, tick body {tick}")
        replays = step_replays(engine, srv, "serving.masked_step") - r0
        if replays != len(ticks):
            raise AssertionError(f"{len(ticks)} constrained ticks, "
                                 f"{replays} masked_step replays")
        texts = ["".join(vocab[t] for t in s) for s in served]
        for text in texts:
            doc = json.loads(text)
            if set(doc) != {"ok", "tag"} or not isinstance(doc["ok"], bool) \
                    or doc["tag"] not in ("a", "b"):
                raise AssertionError(f"{text!r} is not the schema's shape")
        del srv._mask_array
        masked = tl.counter("constraint.masked_tokens")
        if not masked:
            raise AssertionError("no token was masked")
        n_tok = sum(len(s) for s in served)
        out["greedy" if temp == 0 else "sampled"] = {
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ticks": len(ticks), "tick_ms_mean": 1e3 * statistics.mean(ticks),
            "tick_ms_median": 1e3 * statistics.median(ticks),
            "admission_ms": 1e3 * t_admit, "masked_tokens": masked,
            "mask_host_ms_per_tick": 1e3 * statistics.mean(mask_s),
            "masked_step_replays": replays,
            "texts": texts[:3]}
    plain, t_admit, ticks, wall = serve(torch, srv, prompts, wl.NEW)
    n_tok = sum(len(s) for s in plain)
    out["plain"] = {"tokens": n_tok, "tokens_per_s": n_tok / wall,
                    "tick_ms_median": 1e3 * statistics.median(ticks)}
    out["warmup"] = sorted(warm)
    srv.close()
    asrv = wl.make_server("main", params, cfg, async_dispatch=True)
    asrv.warmup(prompt_lens=lens, constrained=True)
    tl.reset()
    served = serve(torch, asrv, prompts, JSON_NEW, constraint=spec)[0]
    fallbacks = asrv.stats().get("constraint.sync_fallbacks", 0)
    asrv.close()
    for s in served:
        json.loads("".join(vocab[t] for t in s))
    if not fallbacks:
        raise AssertionError("the async constrained serve took no sync "
                             "fallback")
    out["async_sync_fallbacks"] = fallbacks
    g, s = out["greedy"], out["sampled"]
    log(f"  constrained JSON on GPT-1.3B main: greedy {g['tokens_per_s']:.1f}"
        f" tokens/s ({g['tokens']} tokens, tick median "
        f"{g['tick_ms_median']:.3f} ms, masks {g['mask_host_ms_per_tick']:.3f}"
        f" host ms a tick), sampled {s['tokens_per_s']:.1f} "
        f"({s['mask_host_ms_per_tick']:.3f} ms), plain "
        f"{out['plain']['tokens_per_s']:.1f} tokens/s (tick median "
        f"{out['plain']['tick_ms_median']:.3f} ms); the tables of the "
        f"spec's {len(seen)} states built in {compile_s:.3f} s; async sync "
        f"fallbacks {fallbacks}; e.g. "
        f"{g['texts'][0]} / {s['texts'][0]}")
    return out, launches


def adapters_phase(torch, gpt, G, serving, engine, ks, wl):
    """The multi-tenant phase: (a) small fp32 models card vs CPU; (b)
    GPT-1.3B under a 4-adapter pool, main and paged; (c) GPT-1.3B
    constrained.  Returns (stats, launches of the gated serves)."""
    from paddle_tpu_torch.text import adapters as A
    from paddle_tpu_torch.text import lora

    t0 = time.perf_counter()
    out = {"small": adapters_small_vs_cpu(torch, gpt, G, serving, A, lora,
                                          engine)}
    log(f"  (a) small fp32 models: {json.dumps(out['small'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    ads = make_adapters(torch, lora, params, cfg, ADAPTER_N, ADAPTER_RANK,
                        ADAPTER_B_STD)
    pool = A.AdapterPool(params, cfg, rank=ADAPTER_RANK,
                         max_adapters=ADAPTER_N)
    for i, ad in enumerate(ads):
        pool.register(f"ad-{i + 1}", ad)
    log(f"  (b) GPT-1.3B pool: {ADAPTER_N} adapters, rank {ADAPTER_RANK}, "
        f"targets {pool.targets}, stacks "
        f"{_tree_bytes(pool.stacks()) / 1e9:.4f} GB fp32 on the card")
    launches = {}
    for path in ("main", "paged"):
        t1 = time.perf_counter()
        out[path], launches[path] = adapter_serve_1p3b(
            torch, gpt, serving, engine, ks, wl, A, lora, path, cfg, params,
            pool, ads)
        log(f"  (b) {path}: {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["constrained"], launches["constrained"] = constrained_1p3b(
        torch, gpt, serving, engine, ks, wl, A, cfg, params)
    log(f"  (c) constrained: {time.perf_counter() - t1:.1f} s")
    del pool, ads
    engine.ENGINE.purge(cfg)
    total = {n: sum(l[n] for l in launches.values())
             for n in launches["main"]}
    out["tc_launches"] = {
        n: out["main"]["tc_launches"].get(n, 0)
        + out["paged"]["tc_launches"].get(n, 0)
        for n in out["main"]["tc_launches"]}
    out["tick_launches"] = {
        n: out["main"]["tick_launches"].get(n, 0)
        + out["paged"]["tick_launches"].get(n, 0)
        for n in out["main"]["tick_launches"]}
    out["phase_s"] = time.perf_counter() - t0
    return out, total


def lora_small_vs_cpu(torch, gpt, lora, optim, woq):
    """(d) Small fp32 LoRA and QLoRA-int8 train runs (5 AdamW steps on
    the attention adapters, one repeated batch, the fused flags off) on
    the card and on the CPU: losses within TRAIN_LOSS_TOL, the base
    unchanged on both."""
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=torch.float32)
    base = gpt.init_master_params(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (4, 65)))
    out = {}
    for name, tree in (("lora", base), ("qlora_int8",
                                         woq.quantize_gpt_int8(base))):
        adapted = lora.lora_init(tree, cfg, rank=8, key=3)
        losses = {}
        for dev in ("cpu", "cuda"):
            p = adapted if dev == "cpu" else _to_card(adapted)
            init, step = lora.build_lora_train_step(
                cfg, optim.AdamW(learning_rate=TRAIN_LR))
            state = init(p)
            ls = []
            with env_set(PADDLE_TPU_FUSED_CE="0", PADDLE_TPU_FUSED_LN="0"):
                for _ in range(TRAIN_STEPS):
                    state, loss = step(state, toks.to(dev), TRAIN_LR)
                    ls.append(float(loss))
            for k, v in state.base["blocks"].items():
                assert torch.equal(v.cpu(), tree["blocks"][k]), k
            losses[dev] = ls
        gap = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        if not gap <= TRAIN_LOSS_TOL or not losses["cuda"][-1] < \
                losses["cuda"][0]:
            raise AssertionError(f"{name}: card {losses['cuda']} vs cpu "
                                 f"{losses['cpu']}")
        out[name] = {"losses": losses["cuda"], "max_gap": gap}
    return out


def lora_rung(torch, gpt, ks, tr, optim, headline):
    """(d) The LoRA rung: GPT-1.3B widths, an fp32 base frozen
    (``init_master_params``), rank-8 adapters on the attention targets,
    AdamW on the adapters alone, batch LORA_BATCH x 2048 in one pass under
    ``PADDLE_TPU_FUSED_CE=1``, 4 steps on one batch.  Gates: the first
    loss near ln V and the last below it, the base bit-unchanged (a hash
    of every leaf's bits before and after) and at its addresses, and each
    step's launches exactly a flash forward, dq and dk/dv a layer and one
    CE forward and backward, the flash ones on the tensor-core bodies.
    Reported beside the headline rung's numbers.  Returns (stats,
    launches)."""
    from paddle_tpu_torch.text import lora

    cfg = gpt.gpt_1p3b()
    L, V = cfg.num_layers, cfg.vocab_size
    base = gpt.init_master_params(cfg, seed=0, device="cuda")

    def bits(tree):
        return {k: (v.data_ptr(), int(v.view(torch.int32).to(torch.int64)
                                       .mul(torch.arange(
                                           1, v.numel() + 1, device=v.device,
                                           dtype=torch.int64).view(v.shape)
                                           % 65521).sum()))
                for k, v in _leaves(tree)}

    before = bits(base)
    params = lora.lora_init(base, cfg, rank=ADAPTER_RANK, key=0)
    n_ad = sum(v.numel() for k, v in params["blocks"].items()
               if "_lora_" in k)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, (LORA_BATCH, tr.SEQ + 1))).cuda()
    opt = optim.AdamW(learning_rate=LORA_LR)
    init, step = lora.build_lora_train_step(cfg, opt)
    state = init(params)
    n_tok = LORA_BATCH * tr.SEQ
    want = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "fused_ce_fwd": 1,
            "fused_ce_bwd": 1, "fused_layer_norm_fwd": 0,
            "fused_layer_norm_bwd": 0, "w4_matmul": 0, "decode_attention": 0,
            "paged_decode_attention": 0}
    want_tc = {n: want[n] for n in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv", "w4_matmul",
                                    "decode_attention",
                                    "paged_decode_attention")}
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ks)
    # the train rungs before leave their flags set: the fused CE on, the
    # fused LN off for this rung
    with env_set(PADDLE_TPU_FUSED_CE="1", PADDLE_TPU_FUSED_LN="0"):
        for i in range(4):
            b, btc = launch_counts(ks), tc_counts(ks)
            t0 = time.perf_counter()
            state, loss = step(state, toks, LORA_LR)
            losses.append(loss.item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            got = {n: c - b[n] for n, c in launch_counts(ks).items()}
            got_tc = {n: c - btc[n] for n, c in tc_counts(ks).items()}
            if got != want or got_tc != want_tc:
                raise AssertionError(f"LoRA step {i + 1} launched {got} "
                                     f"(tensor-core {got_tc}), not {want}")
            log(f"  LoRA step {i + 1}: loss {losses[-1]:.5f}, "
                f"{step_s[-1] * 1e3:.1f} ms, {n_tok / step_s[-1]:.0f} "
                f"tokens/s")
    launches = launch_counts(ks)
    tc = tc_counts(ks)
    peak = torch.cuda.max_memory_allocated()
    if abs(losses[0] - math.log(V)) > 1.0 or not losses[-1] < losses[0]:
        raise AssertionError(f"LoRA losses {losses}")
    if bits(state.base) != before:
        raise AssertionError("the frozen base changed")
    steady = statistics.median(step_s[1:])
    stats = {
        "rung": "gpt_1.3b_lora_r8_attn_b4", "batch": LORA_BATCH,
        "seq": tr.SEQ, "rank": ADAPTER_RANK,
        "targets": sorted({k.rsplit("_lora_", 1)[0]
                           for k in state.adapters}),
        "adapter_params": n_ad, "losses": losses,
        "step_ms": [1e3 * t for t in step_s],
        "steady_step_ms": 1e3 * steady,
        "steady_tokens_per_s": n_tok / steady, "peak_mem_gb": peak / 1e9,
        "optimizer_state_gb": tr.state_bytes(state.opt_state) / 1e9,
        "launches_per_step": want, "tc_launches": tc,
        "base_unchanged": True}
    log(f"  LoRA rung: steady {stats['steady_step_ms']:.1f} ms/step, "
        f"{stats['steady_tokens_per_s']:.0f} tokens/s, peak "
        f"{stats['peak_mem_gb']:.2f} GB, optimizer state "
        f"{stats['optimizer_state_gb'] * 1e3:.3f} MB ({n_ad} adapter "
        f"params) — beside the headline rung "
        f"{headline['steady_step_ms']:.1f} ms/step, "
        f"{headline['steady_tokens_per_s']:.0f} tokens/s, peak "
        f"{headline['peak_mem_gb']:.2f} GB, optimizer state "
        f"{headline['optimizer_state_gb']:.3f} GB")
    del state, params, base
    return stats, launches


def evaluate_phase(torch, gpt, ks):
    """(e) ``nll`` against ``cached_nll`` on GPT-1.3B (bf16, random weights
    from seed 0) over 4 x 513 tokens within EVAL_TOL, and the int8-KV
    ``cached_perplexity`` within EVAL_INT8_REL of the exact cache's, each
    timed; the forward's flash launches on the tensor-core body and every
    decode-path launch on the tick body.  A small fp32 model's ``nll`` and
    ``cached_nll`` card vs CPU within 1e-4.  Returns (stats, launches)."""
    from paddle_tpu_torch.text import evaluate as ev

    small = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                          num_heads=2, max_seq_len=256, dtype=torch.float32)
    cpu = gpt.init_params(small, seed=9, device="cpu")
    batch = np.random.default_rng(8).integers(0, 512, (3, 65))
    vals = {}
    for dev, p in (("cpu", cpu), ("cuda", _to_card(cpu))):
        vals[dev] = (ev.nll(p, small, batch), ev.cached_nll(p, small, batch))
    gap = max(abs(a - b) for a, b in zip(vals["cpu"], vals["cuda"]))
    if not gap <= 1e-4:
        raise AssertionError(f"small eval card {vals['cuda']} vs cpu "
                             f"{vals['cpu']}")
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_layers
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 513))
    zero_counts(ks)
    out = {"small_card_vs_cpu": gap}
    for name, fn, kv in (("nll", ev.nll, ""), ("cached_nll", ev.cached_nll,
                                                ""),
                         ("cached_nll_int8_kv", ev.cached_nll, "int8")):
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn(params, cfg, toks)
        out[name + "_s"] = time.perf_counter() - t0
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    if launches["flash_attention_fwd"] != L or tc["flash_attention_fwd"] != L:
        raise AssertionError(f"the eval forward launched {launches} (tc {tc})")
    if launches["decode_attention"] != 2 * L * 512 \
            or tick["decode_attention"] != 2 * L * 512:
        raise AssertionError(f"the decode-path evals launched {launches} "
                             f"(tick body {tick})")
    d = abs(out["nll"] - out["cached_nll"])
    rel = abs(math.exp(out["cached_nll_int8_kv"])
              - math.exp(out["cached_nll"])) / math.exp(out["cached_nll"])
    out.update(nll_vs_cached=d, int8_kv_ppl_rel=rel,
               launches=launches, tc_launches=tc, tick_launches=tick)
    if not (math.isfinite(out["nll"]) and d <= EVAL_TOL
            and rel <= EVAL_INT8_REL):
        raise AssertionError(f"evaluation: {out}")
    log(f"  GPT-1.3B bf16, 4 x 513 tokens: nll {out['nll']:.5f} "
        f"({out['nll_s']:.2f} s), cached_nll {out['cached_nll']:.5f} "
        f"({out['cached_nll_s']:.2f} s; |delta| {d:.5f}, tol {EVAL_TOL}), "
        f"int8 KV {out['cached_nll_int8_kv']:.5f} "
        f"({out['cached_nll_int8_kv_s']:.2f} s; perplexity {rel:+.5f} "
        f"relative, tol {EVAL_INT8_REL}); small fp32 card vs CPU {gap:.3g}")
    del params
    return out, launches


# ---------------------------------------------------------------------------
# the serving fleet (text/fleet.py)
# ---------------------------------------------------------------------------

FLEET_SHORT = 64                 # the JAX bench's fleet schedule (bench.py
FLEET_LONG = 1536                # bench_fleet): 6 short prompts at
FLEET_SHORTS = 6                 # iteration 0, long ones at 8 and 24,
FLEET_LONG_AT = (8, 24)          # 64 new tokens each
FLEET_NEW = 64
FLEET_MAX_LEN = FLEET_LONG + FLEET_NEW
FLEET_CHUNK_ROWS = "256"         # PADDLE_TPU_STREAM_CHUNK_ROWS' default
FLEET_TOL = 4.0                  # bench.py's BENCH_FLEET_TOL (reported)
FLEET_SMALL_LENS = (5, 40, 100, 17, 60, 33)


def fleet_schedule(vocab, mixed, seed=0):
    """bench_fleet's schedule: [(iteration, prompt)], sorted by iteration;
    the short prompts drawn first, then the long ones, from ``seed``."""
    rng = np.random.default_rng(seed)
    shorts = [rng.integers(1, vocab, FLEET_SHORT).tolist()
              for _ in range(FLEET_SHORTS)]
    longs = [rng.integers(1, vocab, FLEET_LONG).tolist()
             for _ in FLEET_LONG_AT]
    sched = [(0, p) for p in shorts]
    if mixed:
        sched += list(zip(FLEET_LONG_AT, longs))
    return sorted(sched, key=lambda x: x[0])


def fleet_drive(obj, active_fn, sched, new):
    """bench_fleet's drive loop: submit each prompt at its iteration, one
    ``tick()`` an iteration; the decode-loop gaps are the walls of the
    iterations that began with work mid-decode (any submit landing in
    them included).  Returns (streams in schedule order, gaps ms, wall
    s)."""
    sched = list(sched)
    rids, gaps = [], []
    it = 0
    t_start = time.perf_counter()
    while sched or obj.pending():
        act = active_fn() > 0
        t0 = time.perf_counter()
        while sched and sched[0][0] <= it:
            rids.append(obj.submit(sched.pop(0)[1], max_new_tokens=new))
        obj.tick()
        if act:
            gaps.append((time.perf_counter() - t0) * 1e3)
        it += 1
        if it > 50 * new:
            raise AssertionError("the fleet drive did not drain")
    wall = time.perf_counter() - t_start
    return [[int(t) for t in obj.result(r)] for r in rids], gaps, wall


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _fleet_run(fleet, router, prompts, new=12):
    """Submit every prompt to ``router`` at once and tick until drained;
    the streams."""
    rids = [router.submit(p, max_new_tokens=new) for p in prompts]
    deadline = time.time() + 300.0
    while router.pending() and time.time() < deadline:
        router.tick()
        if not any(r._slots or r._queue for r in router.replicas
                   if r is not None):
            time.sleep(0.002)
    if router.pending():
        raise AssertionError("the fleet did not drain")
    return [[int(t) for t in router.result(r)] for r in rids]


def _small_single(serving, cfg, params, dev, layout, prompts, new=12, **kw):
    """One server of the fleet replicas' geometry (max_batch 2: the decode
    kernels' split plan follows the batch, so the streams can be equal
    bit for bit)."""
    lay = dict(layout="paged", block_size=16) if layout == "paged" else {}
    srv = serving.DecodeServer(params, cfg, max_batch=2,
                               max_len=160, device=dev, **lay, **kw)
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    while srv.pending():
        srv.tick()
    out = [[int(t) for t in srv.result(r)] for r in rids]
    srv.close()
    return out


def _small_fleet(fleet, serving, cfg, params, dev, layout, prompts,
                 socket_link=False, **rkw):
    """A loopback (or socket) fleet of 2 replicas (max_batch 2) and one
    worker over the small model on ``dev``, every prompt of 16+ tokens
    handed off; the card's replicas and worker are warmed first.  Returns
    (streams, fleet counters)."""
    from paddle_tpu_torch import telemetry as tl

    lay = dict(layout="paged", block_size=16) if layout == "paged" else {}
    worker = fleet.PrefillWorker(params, cfg, max_len=160, device=dev, **lay)
    reps = [serving.DecodeServer(params, cfg, max_batch=2, max_len=160,
                                 device=dev, **lay) for _ in range(2)]
    if dev == "cuda":
        lens = [len(p) for p in prompts]
        worker.warmup(prompt_lens=lens)
        for r in reps:
            r.warmup(prompt_lens=lens)
    c0 = tl.counters("fleet.")
    listener = None
    if socket_link:
        listener = fleet.serve_prefill_worker(worker)
        pre = [fleet.SocketTransport.connect("127.0.0.1", listener.port)]
    else:
        pre = [worker]
    router = fleet.Router(reps, prefill=pre, prefill_threshold=16, **rkw)
    got = _fleet_run(fleet, router, prompts)
    router.close()
    if listener is not None:
        worker.close()
        listener.close()
    c1 = tl.counters("fleet.")
    return got, {k: v - c0.get(k, 0) for k, v in c1.items()
                 if v - c0.get(k, 0)}


def fleet_small_vs_cpu(torch, gpt, serving, fleet, faults):
    """(a): small fp32 fleets on the card against one card server and the
    same fleet on the CPU.  Returns the cases' records."""
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=256, dtype=torch.float32)
    cpu = gpt.init_params(cfg, seed=0, device="cpu")
    card = _to_card(cpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in FLEET_SMALL_LENS]
    out = {}

    def hold(what, got, ref, cpu_got):
        if got != ref:
            raise AssertionError(f"{what}: the card fleet's streams are not "
                                 f"the card server's: {got} vs {ref}")
        eq = hold_streams(torch, gpt, card, cfg, prompts, cpu_got, got,
                          f"{what} CPU vs card", tol=PATH_TOL)
        return eq

    for layout in ("contiguous", "paged"):
        for rows, kv in (("0", ""), ("8", ""), ("8", "int8")):
            with env_set(PADDLE_TPU_STREAM_CHUNK_ROWS=rows,
                         PADDLE_TPU_KV_DTYPE=kv or None):
                ref = _small_single(serving, cfg, card, "cuda", layout,
                                    prompts)
                got, ctr = _small_fleet(fleet, serving, cfg, card, "cuda",
                                        layout, prompts)
                cgot, cctr = _small_fleet(fleet, serving, cfg, cpu, "cpu",
                                          layout, prompts)
            name = f"{layout} rows={rows} {kv or 'fp32'}"
            if ctr != cctr or not ctr.get("fleet.prefill_handoffs"):
                raise AssertionError(f"{name}: fleet counters card {ctr}, "
                                     f"CPU {cctr}")
            out[name] = {"cpu_equal": hold(name, got, ref, cgot),
                         "counters": ctr}
            log(f"  {name}: streams the card server's, {out[name]}")
    # a socket fleet: the worker served in process over 127.0.0.1
    ref = _small_single(serving, cfg, card, "cuda", "contiguous", prompts)
    got, ctr = _small_fleet(fleet, serving, cfg, card, "cuda", "contiguous",
                            prompts, socket_link=True)
    cgot, _ = _small_fleet(fleet, serving, cfg, cpu, "cpu", "contiguous",
                           prompts, socket_link=True)
    out["socket"] = {"cpu_equal": hold("socket", got, ref, cgot),
                     "counters": ctr}
    if not ctr.get("fleet.prefill_handoffs"):
        raise AssertionError(f"socket fleet: no handoff {ctr}")
    log(f"  socket fleet: {out['socket']}")
    # a live add and remove of a replica
    streams = {}
    for dev, params in (("cuda", card), ("cpu", cpu)):
        mk = lambda: serving.DecodeServer(  # noqa: E731
            params, cfg, max_batch=2, max_len=160, device=dev)
        router = fleet.Router([mk(), mk()])
        rids = [router.submit(p, max_new_tokens=12) for p in prompts]
        for _ in range(2):
            router.tick()
        router.add_replica(mk())
        for _ in range(2):
            router.tick()
        router.remove_replica(0).close()
        while router.pending():
            router.tick()
        streams[dev] = [[int(t) for t in router.result(r)] for r in rids]
        router.close()
    out["add_remove"] = {"cpu_equal": hold("add/remove", streams["cuda"], ref,
                                           streams["cpu"])}
    # the autoscale drill
    from paddle_tpu_torch import telemetry as tl

    with env_set(PADDLE_TPU_FLEET_AUTOSCALE="1", PADDLE_TPU_FLEET_SCALE_RUNG="2",
                 PADDLE_TPU_FLEET_SCALE_OUT_TICKS="2",
                 PADDLE_TPU_FLEET_SCALE_IN_TICKS="3"):
        srv = serving.DecodeServer(card, cfg, max_batch=2, max_len=160)
        spare = serving.DecodeServer(card, cfg, max_batch=2, max_len=160)
        router = fleet.Router([srv])
        router.register_spare(spare)
        orig = srv.load_stats
        srv.load_stats = lambda: dict(orig(), admission_rung=2,
                                      queue_depth=1)
        live = []
        c0 = tl.counters("fleet.")
        for _ in range(2):
            router.tick()
            live.append(sum(r is not None for r in router.replicas))
        srv.load_stats = orig
        auto = _fleet_run(fleet, router, prompts[:2])
        for _ in range(4):
            router.tick()
            live.append(sum(r is not None for r in router.replicas))
        c1 = tl.counters("fleet.")
        router.close()
    outs = c1.get("fleet.scale_outs", 0) - c0.get("fleet.scale_outs", 0)
    ins = c1.get("fleet.scale_ins", 0) - c0.get("fleet.scale_ins", 0)
    if live[:2] != [1, 2] or live[-1] != 1 or outs != 1 or ins != 1:
        raise AssertionError(f"autoscale: live replicas {live}, scale outs "
                             f"{outs}, ins {ins}")
    if auto != ref[:2]:
        raise AssertionError("autoscale: the streams are not the server's")
    out["autoscale"] = {"live": live, "scale_outs": outs, "scale_ins": ins}
    # chain migration between paged replicas
    with env_set(PADDLE_TPU_KV_SPILL_MB="4"):
        long_p = prompts[2][:64]
        mk = lambda: serving.DecodeServer(  # noqa: E731
            card, cfg, max_batch=2, max_len=160, layout="paged",
            block_size=16)
        a, b = mk(), mk()
        router = fleet.Router([a, b])
        r0 = a.submit(long_p, max_new_tokens=12)
        while a.pending():
            a.tick()
        warm0 = [int(t) for t in a.result(r0)]
        for _ in range(8):
            if not a._pool.prefix_entries:
                break
            a._evict_or_spill(8)
        spilled = len(a._pool._spilled)
        router._migrate_chains({"prompt": long_p}, 1)
        moved = (len(a._pool._spilled), len(b._pool._spilled))
        r1 = b.submit(long_p, max_new_tokens=12)
        while b.pending():
            b.tick()
        warm1 = [int(t) for t in b.result(r1)]
        st = b._pool.stats()
        router.close()
    if not spilled or moved[0] or not moved[1] or warm1 != warm0 \
            or st["restored_blocks"] < 1 or st["chain_migrations"] < 1:
        raise AssertionError(f"chain migration: spilled {spilled}, after "
                             f"the move {moved}, stats {st}, streams equal "
                             f"{warm1 == warm0}")
    out["migration"] = {"chains": moved[1],
                        "restored_blocks": st["restored_blocks"],
                        "chain_migrations": st["chain_migrations"]}
    log(f"  add/remove, autoscale, migration: "
        f"{json.dumps({k: out[k] for k in ('add_remove', 'autoscale', 'migration')})}")
    return out


def _named_replays(engine, binds):
    """{graph name: replays} over the graphs of ``binds``."""
    out = {}
    for b in binds:
        for g in engine.ENGINE.graphs(b):
            out[g.name] = out.get(g.name, 0) + g.replays
    return out


def _grown(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _hist_delta(tl, name, before):
    s = tl.hist(name).summary()
    n = s["count"] - before[0]
    return (s["sum"] - before[1]) / n if n else 0.0, n


def fleet_arm(torch, engine, ks, tl, obj, binds, active_fn, sched, L):
    """One measured pass of ``sched`` through ``obj`` (a server or a
    router), counters zeroed just before and read after (every thread
    idle).  Returns its record."""
    replays0 = _named_replays(engine, binds)
    graphs0 = len(engine.ENGINE.graphs())
    builds0 = len(tl.compile_log())
    fleet0 = tl.counters("fleet.")
    h = tl.hist("fleet.prefill_ms").summary()
    ms0 = (h["count"], h["sum"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ks)
    streams, gaps, wall = fleet_drive(obj, active_fn, sched, FLEET_NEW)
    torch.cuda.synchronize()
    launches, tc, tick = launch_counts(ks), tc_counts(ks), tick_counts(ks)
    grown = _grown(_named_replays(engine, binds), replays0)
    fl = tl.counters("fleet.")
    fl = {k: v - fleet0.get(k, 0) for k, v in fl.items()
          if v - fleet0.get(k, 0)}
    handoff_ms, handoffs_timed = _hist_delta(tl, "fleet.prefill_ms", ms0)
    toks = sum(len(s) for s in streams)
    rec = {"gap_p50_ms": _pct(gaps, 50), "gap_p99_ms": _pct(gaps, 99),
           "gap_max_ms": max(gaps) if gaps else 0.0, "gaps": len(gaps),
           "tokens_per_s": toks / wall, "wall_s": wall,
           "prefill_handoffs": fl.get("fleet.prefill_handoffs", 0),
           "stream_chunks": fl.get("fleet.stream_chunks", 0),
           "stream_bytes": fl.get("fleet.stream_bytes", 0),
           "handoff_ms_mean": handoff_ms, "handoffs_timed": handoffs_timed,
           "reserved_gb": torch.cuda.memory_reserved() / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "captures_after_warmup": len(engine.ENGINE.graphs()) - graphs0,
           "builds_after_warmup": len(tl.compile_log()) - builds0,
           "replays": grown}
    steps = sum(n for g, n in grown.items() if g == "serving.step")
    chunks = sum(n for g, n in grown.items()
                 if g.startswith("serving.prefill_chunk@"))
    prefills = sum(n for g, n in grown.items()
                   if g.startswith("serving.prefill@"))
    rec["launches"] = {"decode_attention": launches["decode_attention"],
                       "decode_tick": tick["decode_attention"],
                       "decode_tc": tc["decode_attention"],
                       "flash": launches["flash_attention_fwd"],
                       "flash_tc": tc["flash_attention_fwd"]}
    want = {"decode_attention": L * (steps + chunks),
            "decode_tick": L * steps, "decode_tc": L * chunks,
            "flash": L * prefills, "flash_tc": L * prefills}
    if rec["launches"] != want:
        raise AssertionError(f"fleet launches {rec['launches']}, the "
                             f"replays say {want} ({grown})")
    if rec["captures_after_warmup"] or rec["builds_after_warmup"]:
        raise AssertionError(f"captures after warmup "
                             f"{rec['captures_after_warmup']}, builds "
                             f"{tl.compile_log()[builds0:]}")
    return rec, streams, {"launches": launches, "tc": tc, "tick": tick}


def fleet_arm_twice(torch, engine, ks, tl, obj, binds, active_fn, sched, L,
                    total):
    """:func:`fleet_arm` twice in a row (host-clock gaps swing between
    passes): the first pass's record with the second's under
    ``"repeat"``, the last pass's streams, both passes' launches added to
    ``total``; the streams of the two passes must be equal."""
    rec, streams, part = fleet_arm(torch, engine, ks, tl, obj, binds,
                                   active_fn, sched, L)
    _add_counts_to(total, part)
    rep, streams2, part = fleet_arm(torch, engine, ks, tl, obj, binds,
                                    active_fn, sched, L)
    _add_counts_to(total, part)
    if streams2 != streams:
        raise AssertionError("two passes of one schedule served other "
                             "streams")
    rec["repeat"] = {k: v for k, v in rep.items()
                     if k not in ("replays", "launches")}
    return rec, streams, part


def _add_counts_to(total, part):
    for k in ("launches", "tc", "tick"):
        for n, v in part[k].items():
            total[k][n] = total[k].get(n, 0) + v


def fleet_1p3b(torch, gpt, serving, fleet, engine, ks, tl, total):
    """(b): the mixed schedule on GPT-1.3B, contiguous."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_layers
    mixed = fleet_schedule(cfg.vocab_size, True)
    short = fleet_schedule(cfg.vocab_size, False)
    lens = [FLEET_SHORT, FLEET_LONG]
    arms = {}
    os.environ["PADDLE_TPU_STREAM_CHUNK_ROWS"] = FLEET_CHUNK_ROWS
    try:
        srv = serving.DecodeServer(params, cfg, max_batch=8,
                                   max_len=FLEET_MAX_LEN)
        srv.warmup(prompt_lens=lens)
        act = lambda: len(srv._slots)  # noqa: E731
        fleet_drive(srv, act, mixed, FLEET_NEW)          # warm pass
        arms["single"], single, part = fleet_arm_twice(
            torch, engine, ks, tl, srv, [srv._bind], act, mixed, L, total)
        srv.close()
        gc.collect()
        torch.cuda.empty_cache()
        worker = fleet.PrefillWorker(params, cfg, max_len=FLEET_MAX_LEN)
        worker.warmup(prompt_lens=[FLEET_LONG],
                      chunk_rows=int(FLEET_CHUNK_ROWS))
        reps = [serving.DecodeServer(params, cfg, max_batch=4,
                                     max_len=FLEET_MAX_LEN)
                for _ in range(2)]
        for r in reps:
            r.warmup(prompt_lens=lens)
        router = fleet.Router(reps, prefill=[worker],
                              prefill_threshold=(FLEET_SHORT
                                                 + FLEET_LONG) // 2)
        binds = [r._bind for r in reps] + [worker._bind]
        act = lambda: sum(len(r._slots) for r in reps)  # noqa: E731
        for name, sched, rows in (("fleet_short", short, FLEET_CHUNK_ROWS),
                                  ("fleet_mixed", mixed, FLEET_CHUNK_ROWS),
                                  ("fleet_mixed_whole", mixed, "0")):
            os.environ["PADDLE_TPU_STREAM_CHUNK_ROWS"] = rows
            fleet_drive(router, act, sched, FLEET_NEW)   # warm pass
            arms[name], got, part = fleet_arm_twice(
                torch, engine, ks, tl, router, binds, act, sched, L, total)
            if name == "fleet_short":
                continue
            if {arms[name]["prefill_handoffs"],
                    arms[name]["repeat"]["prefill_handoffs"]} \
                    != {len(FLEET_LONG_AT)}:
                raise AssertionError(f"{name}: {arms[name]['prefill_handoffs']}"
                                     f" handoffs, not {len(FLEET_LONG_AT)}")
            prompts = [p for _, p in mixed]
            arms[name]["streams_equal"] = hold_streams(
                torch, gpt, params, cfg, prompts, got, single, name)
            arms[name]["streams"] = len(got)
            replays = arms[name]["replays"]
            want = ("serving.prefill_chunk@" if rows != "0"
                    else "serving.prefill@")
            if not any(g.startswith(want) for g in replays):
                raise AssertionError(f"{name}: the worker ran no "
                                     f"{want}: {replays}")
        router.close()
    finally:
        os.environ.pop("PADDLE_TPU_STREAM_CHUNK_ROWS", None)
    for name, rec in arms.items():
        for i, r in enumerate((rec, rec["repeat"])):
            log(f"  {name} pass {i + 1}: gap p50 {r['gap_p50_ms']:.3f} ms, "
                f"p99 {r['gap_p99_ms']:.3f} ms (max {r['gap_max_ms']:.3f}, "
                f"{r['gaps']} gaps), {r['tokens_per_s']:.1f} tokens/s, "
                f"handoffs {r['prefill_handoffs']}, stream chunks "
                f"{r['stream_chunks']} ({r['stream_bytes']} bytes), worker "
                f"{r['handoff_ms_mean']:.3f} ms a handoff "
                f"({r['handoffs_timed']}), reserved "
                f"{r['reserved_gb']:.2f} GB, streams equal "
                f"{rec.get('streams_equal', '-')}")

    def best(name):
        rec = arms[name]
        return min(rec["gap_p99_ms"], rec["repeat"]["gap_p99_ms"])

    ratio = best("fleet_mixed") / max(best("fleet_short"), 1e-9)
    ratio_whole = best("fleet_mixed_whole") / max(best("fleet_short"), 1e-9)
    log(f"  gap p99 mixed fleet / short-only fleet, best of 2 passes each: "
        f"{ratio:.3f} streamed, {ratio_whole:.3f} whole (the JAX bench's "
        f"bar {FLEET_TOL}, reported); single server mixed p99 "
        f"{best('single'):.3f} ms")
    del params
    return {"arms": arms, "gap_p99_ratio": ratio,
            "gap_p99_ratio_whole": ratio_whole, "bar": FLEET_TOL}


def fleet_paged_1p3b(torch, gpt, serving, fleet, engine, ks, tl, wl,
                     total):
    """(c): 2 paged replicas and a paged worker on the paged path's chat
    prompts against one paged server."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_layers
    prompts = wl.paged_prompts(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    srv = serving.DecodeServer(params, cfg, **wl.PAGED_GEOMETRY)
    srv.warmup(prompt_lens=lens)
    ref, _, _, _ = serve(torch, srv, prompts, wl.NEW)
    ref = [[int(t) for t in s] for s in ref]
    srv.close()
    geo = dict(wl.PAGED_GEOMETRY, max_batch=4, num_blocks=96)
    reps = [serving.DecodeServer(params, cfg, **geo) for _ in range(2)]
    for r in reps:
        r.warmup(prompt_lens=lens)
    worker = fleet.PrefillWorker(params, cfg, max_len=geo["max_len"],
                                 layout="paged", block_size=16)
    worker.warmup(prompt_lens=lens, chunk_rows=int(FLEET_CHUNK_ROWS))
    binds = [r._bind for r in reps] + [worker._bind]
    os.environ["PADDLE_TPU_STREAM_CHUNK_ROWS"] = FLEET_CHUNK_ROWS
    try:
        # the Router warms the replicas' inject steps at the worker's lens
        router = fleet.Router(reps, prefill=[worker], prefill_threshold=250)
        replays0 = _named_replays(engine, binds)
        fl0 = tl.counters("fleet.")
        zero_counts(ks)
        got = _fleet_run(fleet, router, prompts, new=wl.NEW)
        torch.cuda.synchronize()
        launches, tc, tick = launch_counts(ks), tc_counts(ks), \
            tick_counts(ks)
        grown = _grown(_named_replays(engine, binds), replays0)
        router.close()
    finally:
        os.environ.pop("PADDLE_TPU_STREAM_CHUNK_ROWS", None)
    _add_counts_to(total, {"launches": launches, "tc": tc, "tick": tick})
    fl = {k: v - fl0.get(k, 0) for k, v in tl.counters("fleet.").items()
          if v - fl0.get(k, 0)}
    steps = grown.get("serving.step", 0)
    chunks = sum(n for g, n in grown.items()
                 if g.startswith("serving.paged_prefill"))
    have = {"paged": launches["paged_decode_attention"],
            "tick": tick["paged_decode_attention"],
            "tc": tc["paged_decode_attention"],
            "decode_attention": launches["decode_attention"]}
    want = {"paged": L * (steps + chunks), "tick": L * steps,
            "tc": L * chunks, "decode_attention": 0}
    if have != want:
        raise AssertionError(f"paged fleet launches {have}, the replays say "
                             f"{want} ({grown})")
    if not fl.get("fleet.prefill_handoffs"):
        raise AssertionError(f"paged fleet: no handoff {fl}")
    equal = hold_streams(torch, gpt, params, cfg, prompts, got, ref,
                         "paged fleet")
    rec = {"streams_equal": equal, "streams": len(got), "launches": have,
           "counters": fl}
    log(f"  paged fleet: {json.dumps(rec)}")
    del params
    return rec


def fleet_wedge_1p3b(torch, gpt, serving, fleet, faults, tl):
    """(d): the JAX bench's wedge round on a GPT-1.3B fleet of 2 async
    one-slot replicas."""
    cfg = gpt.gpt_1p3b()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, FLEET_SHORT).tolist()
               for _ in range(4)]
    new = 16
    srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=512,
                               async_dispatch=True)
    srv.warmup(prompt_lens=[FLEET_SHORT])
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    while srv.pending():
        srv.tick()
    ref = [[int(t) for t in srv.result(r)] for r in rids]
    srv.close()
    reroutes0 = tl.counter("fleet.reroutes")
    saw, health = False, None
    with env_set(PADDLE_TPU_STEP_BUDGET_S="0.25",
                 PADDLE_TPU_FAULT_WEDGE_S="0.8"):
        reps = [serving.DecodeServer(params, cfg, max_batch=1, max_len=512,
                                     async_dispatch=True) for _ in range(2)]
        for r in reps:
            r.warmup(prompt_lens=[FLEET_SHORT])
        faults.install("wedge:tick:1")
        try:
            router = fleet.Router(reps)
            rids = [router.submit(p, max_new_tokens=new) for p in prompts]
            for _ in range(50 * new):
                if not router.pending():
                    break
                router.tick()
                if not router.healthz()["ok"]:
                    saw = True
            if router.pending():
                raise AssertionError("the wedge drill did not drain")
            got = [[int(t) for t in router.result(r)] for r in rids]
            health = router.healthz()["ok"]
            router.close()
        finally:
            faults.reset()
            tl.clear_runtime_wedge()
    reroutes = tl.counter("fleet.reroutes") - reroutes0
    if not saw or not health or reroutes < 1:
        raise AssertionError(f"wedge drill: unhealthy seen {saw}, healthy "
                             f"after {health}, reroutes {reroutes}")
    equal = hold_streams(torch, gpt, params, cfg, prompts, got, ref,
                         "fleet wedge drill")
    rec = {"reroutes": reroutes, "healthz_flipped": saw,
           "healthz_recovered": health, "streams_equal": equal,
           "streams": len(got)}
    log(f"  wedge drill: {json.dumps(rec)}")
    del params
    return rec


def fleet_phase(torch, gpt, serving, engine, ks, wl):
    """The fleet phase: (a) small fp32 fleets card against CPU, (b) the
    1.3B mixed schedule, (c) the 1.3B paged fleet, (d) the wedge drill.
    Returns (record, the phase's launch counts by wrapper, its tc and tick
    counts)."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch import telemetry as tl
    from paddle_tpu_torch.text import fleet

    t0 = time.perf_counter()
    total = {"launches": {}, "tc": {}, "tick": {}}
    zero_counts(ks)
    small = fleet_small_vs_cpu(torch, gpt, serving, fleet, faults)
    _add_counts_to(total, {"launches": launch_counts(ks),
                           "tc": tc_counts(ks), "tick": tick_counts(ks)})
    t_small = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    mixed = fleet_1p3b(torch, gpt, serving, fleet, engine, ks, tl, total)
    gc.collect()
    torch.cuda.empty_cache()
    paged = fleet_paged_1p3b(torch, gpt, serving, fleet, engine, ks, tl, wl,
                             total)
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts(ks)
    wedge = fleet_wedge_1p3b(torch, gpt, serving, fleet, faults, tl)
    _add_counts_to(total, {"launches": launch_counts(ks),
                           "tc": tc_counts(ks), "tick": tick_counts(ks)})
    rec = {"small_vs_cpu": small, "mixed": mixed, "paged": paged,
           "wedge": wedge, "small_s": t_small,
           "phase_s": time.perf_counter() - t0,
           "tc_launches": total["tc"], "tick_launches": total["tick"]}
    return rec, total["launches"]


def expected_train_launches(cfg, rung, remat_policies):
    """Each kernel's launches in one step of ``rung``: per micro-batch a
    flash forward, dq and dk/dv a layer, the CE forward and backward once,
    and on the fused-LN rungs every LayerNorm (two a block and the final
    one) forward and backward once — plus, under remat with a checkpoint
    (any policy but "everything"), each block's flash forward and its two
    LayerNorm forwards again in the recompute.  Checkpoint early stop
    cuts none of these: a block's last saved tensor is the FFN output
    matmul's input, after both norms and the attention."""
    L, A = cfg.num_layers, rung.accum
    again = int(cfg.remat and remat_policies.canonical(cfg.remat_policy)
                != "everything")
    ln = int(rung.flags["PADDLE_TPU_FUSED_LN"] == "1")
    return {"flash_attention_fwd": L * A * (1 + again),
            "flash_attention_bwd_dq": L * A,
            "flash_attention_bwd_dkv": L * A,
            "fused_ce_fwd": A, "fused_ce_bwd": A,
            "fused_layer_norm_fwd": ((2 * L + 1) + 2 * L * again) * A * ln,
            "fused_layer_norm_bwd": (2 * L + 1) * A * ln,
            "w4_matmul": 0, "decode_attention": 0,
            "paged_decode_attention": 0}


def forward_bytes(torch, gpt, cfg, params, tokens, key=None):
    """Bytes one micro-batch's forward (``loss_fn`` on its one sequence,
    the masters as fresh autograd leaves, as the step takes them; under
    the step's ``key``) leaves allocated for its backward: what remat
    trades against recompute."""
    leaves = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss = gpt.loss_fn(leaves, tokens[:1], cfg, key=key)
    kept = torch.cuda.memory_allocated() - before
    del loss
    return kept


def train_path(torch, gpt, ks, tr, remat_policies, rung, steps=4):
    """``steps`` train steps of ``rung`` (``tr.RUNGS``) on one batch under
    the rungs' one key (``tr.KEY``), each timed on the host clock (it
    ends in a sync: the loss is read), with every kernel's launches
    counted per step and the step's memory split at the optimizer update
    (the peak of the micro-batches' phase, and of the update; allocated
    and requested bytes); then the bytes one micro-batch's forward keeps,
    and on an MoE rung the routing of micro-batch 0 at init and after the
    steps (``moe_train_routing``, outside the counted steps).  Returns
    (stats, launches)."""
    r = tr.RUNGS[rung]
    cfg, opt, init_fn, step_fn, tokens = tr.build_train_path(
        "cuda", seed=0, rung=rung)
    key = tr.KEY
    state = init_fn(0)
    # the tree's own size: gpt.count_params is the JAX package's count,
    # which sees one dense FFN a block on an MoE config
    n_params = sum(t.numel() for _, t in _leaves(state.params))
    assert cfg.moe is not None or n_params == gpt.count_params(cfg)
    assert all(t.dtype == torch.float32 for _, t in _leaves(state.params))
    n_tok = r.batch * tr.SEQ
    fpt = gpt.flops_per_token(cfg, tr.SEQ)
    fpt_routed = moe_train_flops_per_token(cfg, tr.SEQ)
    log(f"  hidden {cfg.hidden_size}, {cfg.num_layers} layers"
        f"{'' if cfg.moe is None else f', {cfg.moe}'}: {n_params} "
        f"fp32 master params; batch {r.batch} x {tr.SEQ} tokens in "
        f"{r.accum} micro-batches; remat {cfg.remat} (policy "
        f"{cfg.remat_policy}); {r.describe()}; step key {key}; optimizer "
        f"state {tr.state_bytes(state.opt_state) / 1e9:.3f} GB; flops/token "
        f"{fpt:.4g} (the JAX count), routed {fpt_routed:.4g}")
    want = expected_train_launches(cfg, r, remat_policies)
    phase = {}
    apply = opt.apply_gradients

    def requested_peak():
        # the bytes the program asked for, without the caching allocator's
        # rounding and unsplit block tails (up to 1 MiB an allocation, by
        # the cache's history): what a remat twin's gate compares
        return torch.cuda.memory_stats().get("requested_bytes.all.peak", 0)

    def split_at_update(*args, **kwargs):
        # the peak since the step began is the micro-batches' phase; the
        # update's own peak is read after it
        phase["grads"] = torch.cuda.max_memory_allocated()
        phase["grads_requested"] = requested_peak()
        torch.cuda.reset_peak_memory_stats()
        out = apply(*args, **kwargs)
        phase["update"] = torch.cuda.max_memory_allocated()
        phase["update_requested"] = requested_peak()
        return out

    routing0 = (None if cfg.moe is None else moe_train_routing(
        torch, gpt, cfg, state.params, tokens, key))
    opt.apply_gradients = split_at_update
    torch.cuda.synchronize()
    zero_counts(ks)
    losses, step_s, per_step, per_step_tc, peaks = [], [], [], [], []
    for _ in range(steps):
        before, before_tc = launch_counts(ks), tc_counts(ks)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loss = step_fn(state, tokens, key, tr.LR)
        losses.append(loss.item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        peaks.append(dict(phase))
        per_step.append({n: c - before[n]
                         for n, c in launch_counts(ks).items()})
        per_step_tc.append({n: c - before_tc[n]
                            for n, c in tc_counts(ks).items()})
        log(f"  step {len(losses)}: loss {losses[-1]:.5f}, "
            f"{step_s[-1] * 1e3:.1f} ms, {n_tok / step_s[-1]:.0f} tokens/s, "
            f"peak GB micro-batches {phase['grads'] / 1e9:.2f} / update "
            f"{phase['update'] / 1e9:.2f}, launches {per_step[-1]}")
    launches = launch_counts(ks)
    opt.apply_gradients = apply
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg.vocab_size})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"step {i + 1} launched {got}, not {want}")
    # every flash forward (the recompute's too), dq and dk/dv of every step
    # on the tensor-core bodies (bf16, head_dim 128)
    want_tc = {name: want[name] for name in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "w4_matmul", "decode_attention",
        "paged_decode_attention")}
    for i, got in enumerate(per_step_tc):
        if got != want_tc:
            raise AssertionError(f"step {i + 1} launched {got} on the "
                                 f"tensor-core bodies, not {want_tc}")
    tc = tc_counts(ks)
    if tc != {n: steps * c for n, c in want_tc.items()}:
        raise AssertionError(f"tensor-core launches {tc} in {steps} steps")
    kept = forward_bytes(torch, gpt, cfg, state.params, tokens, key)
    routing = (None if cfg.moe is None else
               moe_train_routing(torch, gpt, cfg, state.params, tokens, key))
    steady = statistics.median(step_s[1:])
    grads_peak = max(p["grads"] for p in peaks)
    update_peak = max(p["update"] for p in peaks)
    requested = max(max(p["grads_requested"], p["update_requested"])
                    for p in peaks)
    stats = {
        "rung": rung + (" + fused CE" if rung == "gpt_1.3b_acc8_b8" else ""),
        "hidden": cfg.hidden_size, "layers": cfg.num_layers,
        "params": n_params, "batch": r.batch, "seq": tr.SEQ,
        "accum": r.accum, "remat": cfg.remat,
        "remat_policy": cfg.remat_policy, "optimizer": r.describe(),
        "optimizer_state_gb": tr.state_bytes(state.opt_state) / 1e9,
        "flags": r.flags, "losses": losses,
        "step_ms": [1e3 * t for t in step_s],
        "tokens_per_s": [n_tok / t for t in step_s],
        "steady_step_ms": 1e3 * steady,
        "steady_tokens_per_s": n_tok / steady,
        "mfu": fpt * n_tok / steady / BF16_FLOPS_PER_S,
        "mfu_routed": fpt_routed * n_tok / steady / BF16_FLOPS_PER_S,
        "peak_mem_gb": max(grads_peak, update_peak) / 1e9,
        "peak_micro_batches_gb": grads_peak / 1e9,
        "peak_update_gb": update_peak / 1e9,
        "peak_requested_gb": requested / 1e9,
        "forward_kept_gb": kept / 1e9,
        "launches_per_step": per_step[-1],
        "tc_launches_per_step": per_step_tc[-1], "tc_launches": tc,
    }
    if routing is not None:
        stats.update(routing_at_init=routing0, routing=routing)
        log(f"  routing of micro-batch 0 under its step key: at init "
            f"{json.dumps(routing0)}; weights after the last step "
            f"{json.dumps(routing)}")
    log(f"  steady (median of steps 2-{steps}): {stats['steady_step_ms']:.1f}"
        f" ms/step, {stats['steady_tokens_per_s']:.0f} tokens/s, MFU "
        f"{stats['mfu']:.4f} (routed {stats['mfu_routed']:.4f}); peak "
        f"memory {stats['peak_mem_gb']:.2f} GB (requested "
        f"{stats['peak_requested_gb']:.4f}) "
        f"(micro-batches {grads_peak / 1e9:.2f}, update "
        f"{update_peak / 1e9:.2f}); one micro-batch's forward keeps "
        f"{kept / 1e9:.3f} GB")
    del state
    return stats, launches


# the train rungs the smoke drives (tools/profile_train.RUNGS), in order;
# each remat rung is held against the remat-off twin named beside it
TRAIN_RUNGS = (("train", "gpt_1.3b_acc8_b8", None),
               ("train_fused", "gpt_1.3b_fused_acc8_b8", None),
               ("train_760m", "gpt_760m_fused_acc16_b16", None),
               ("train_760m_dots", "gpt_760m_fused_dots_acc16_b16",
                "train_760m"),
               ("train_1.3b_remat_af", "gpt_1.3b_fused_remat_af_acc8_b8",
                "train_fused"),
               ("train_moe", "gpt_1.3b_moe8_l8_fused_acc8_b8", None),
               ("train_moe_remat", "gpt_1.3b_moe8_l8_fused_remat_acc8_b8",
                "train_moe"))


# ---------------------------------------------------------------------------
# hybrid-parallel training: ranks over torch.distributed
# ---------------------------------------------------------------------------

HYBRID_RANKS = 4
HYBRID_FLAGS = {"PADDLE_TPU_FUSED_CE": "1", "PADDLE_TPU_FUSED_LN": "1"}
# AdamW steps of the small fp32 runs, (a), (d) and the data and comm
# phase's (c), by backend: on one card (gloo) three, to keep the whole
# smoke inside its time; on four (NCCL) five; each parameter gate scales
# with the steps taken
HYBRID_SMALL_STEPS = {"gloo": 3, "nccl": 5}
# the small models: check_train_vs_cpu's base and its GQA variant
HYBRID_BASE = dict(vocab_size=512, hidden_size=256, num_layers=2,
                   num_heads=2, max_seq_len=128)
HYBRID_GQA = dict(num_heads=4, num_kv_heads=2, hidden_size=512,
                  pos_embed="rope", norm="rmsnorm", activation="swiglu")
HYBRID_CLIP = 0.05               # below the small models' gradient norm
# (name, config fields over HYBRID_BASE, mesh, step arguments, clip norm)
HYBRID_SMALL_RUNS = (
    ("mha dp2 x mp2", {}, {"dp": 2, "mp": 2}, {}, None),
    ("gqa-rope-rmsnorm-swiglu dp2 x mp2", HYBRID_GQA, {"dp": 2, "mp": 2},
     {}, None),
    ("mha pp2 x mp2 1f1b M=2", {}, {"pp": 2, "mp": 2}, {"n_micro": 2},
     None),
    ("mha pp2 x mp2 1f1b M=4", {}, {"pp": 2, "mp": 2}, {"n_micro": 4},
     None),
    ("mha pp2 x mp2 fthenb M=2", {}, {"pp": 2, "mp": 2},
     {"n_micro": 2, "schedule": "fthenb"}, None),
    ("mha pp2 x mp2 fthenb M=4", {}, {"pp": 2, "mp": 2},
     {"n_micro": 4, "schedule": "fthenb"}, None),
    *((f"mha dp4 zero {z}", {}, {"dp": 4}, {"zero": z}, None)
      for z in range(4)),
    ("mha dp2 x mp2 clip", {}, {"dp": 2, "mp": 2}, {}, HYBRID_CLIP),
)
# (d) the sp and ep axes on the small models: ring attention (kernels #1-#3
# on the ring's live blocks), expert parallelism; MoE fields as a dict (the
# MoEConfig is made once torch is imported).  The dp2 x sp2 MoE run routes
# each sequence chunk on its own (JAX's manual path), so it is dropless and
# without the aux loss, whose product of means a chunk changes — then it is
# the one-card step's function.
HYBRID_MOE = {"moe": dict(num_experts=4, top_k=2, capacity_factor=1.0,
                          aux_loss_weight=0.01)}
HYBRID_MOE_CHUNKED = {"moe": dict(num_experts=4, top_k=2, capacity_factor=2.0,
                                  aux_loss_weight=0.0)}
# ... but its ring sums attention in another order than one card's flash,
# so a router logit's last bit can flip a near-tied top-2 choice and move
# a token to another expert: that run's step-1 loss (the initial routing)
# is held to TRAIN_LOSS_TOL, its later losses to this, and its params are
# reported, not gated
HYBRID_ROUTED_TOL = 2e-3
HYBRID_GQA_RING = dict(num_heads=4, num_kv_heads=2, hidden_size=512)
HYBRID_SP_RUNS = (
    ("mha sp2 x mp2", {}, {"sp": 2, "mp": 2}, {}, None),
    ("mha sp2 x mp2 zigzag", {}, {"sp": 2, "mp": 2}, {"sp_zigzag": True},
     None),
    ("mha sp2 x mp2 sub 16", {"sp_sub_block": 16}, {"sp": 2, "mp": 2}, {},
     None),
    ("mha sp2 x mp2 zigzag sub 16", {"sp_sub_block": 16}, {"sp": 2, "mp": 2},
     {"sp_zigzag": True}, None),
    ("mha pp2 x sp2 1f1b M=2", {}, {"pp": 2, "sp": 2}, {"n_micro": 2}, None),
    ("mha pp2 x sp2 fthenb M=2", {}, {"pp": 2, "sp": 2},
     {"n_micro": 2, "schedule": "fthenb"}, None),
    ("mha sp4 zigzag", {}, {"sp": 4}, {"sp_zigzag": True}, None),
    ("gqa sp2 x mp2", HYBRID_GQA_RING, {"sp": 2, "mp": 2}, {}, None),
    ("moe dp2 x ep2", HYBRID_MOE, {"dp": 2, "ep": 2}, {}, None),
    ("moe ep2 x mp2", HYBRID_MOE, {"ep": 2, "mp": 2}, {}, None),
    ("moe pp2 x ep2 1f1b", HYBRID_MOE, {"pp": 2, "ep": 2}, {"n_micro": 1},
     None),
    ("moe dp2 x sp2", HYBRID_MOE_CHUNKED, {"dp": 2, "sp": 2}, {}, None),
)
# (e) the ring's kernel route against its plain twin at GPT-1.3B's
# attention: head dim 128, 16 heads (8 under mp 2), T = 2048, bf16
HYBRID_RING_SHAPES = (
    ("sp4", {"sp": 4}, 16, False), ("sp4 zigzag", {"sp": 4}, 16, True),
    ("sp2 (mp2 heads)", {"sp": 2, "mp": 2}, 8, False),
    ("sp2 zigzag (mp2 heads)", {"sp": 2, "mp": 2}, 8, True))
# GPT-1.3B at pp2 x mp2, 1F1B, 8 micro-batches: step 1's loss against the
# one-card headline rung's step-1 loss on the same masters and batch
# (bf16: the mp split sums the heads and the vocab in another order)
HYBRID_1P3B_LOSS_TOL = 0.02
HYBRID_1P3B_RUNG = "gpt_1.3b_fused_acc8_b8"
# steps 1-2 gated and timed; on four cards step 3 profiled (one card's
# profile measures the sharing, and its step is cut to keep the smoke's
# time)
HYBRID_1P3B_STEPS = {"gloo": 2, "nccl": 3}
# (f) sp and ep at full width on the batch's first rows, and the MoE rung's
# depth, by backend: four ranks sharing one card's 80 GB each peak at the
# update near 20 bytes a parameter they hold (old and new masters and
# moments, the synced gradients), sp2 x mp2 holding half of GPT-1.3B's
# 1.3 G and ep4 a quarter of the MoE rung's experts (PERF.md, PR 23)
HYBRID_MOE_RUNG = "gpt_1.3b_moe8_l8_fused_acc8_b8"
HYBRID_SP_ROWS = {"gloo": 1, "nccl": 8}
HYBRID_MOE_LAYERS = {"gloo": 4, "nccl": 8}
# the dense GPT-1.3B arms' depth, (b) and (f), by backend: four ranks
# sharing one card step a 24-layer model in 6.6-17 s (PR 25's whole
# smoke), so one card runs 8 (each arm held to the one-card loss at that
# depth) to keep the whole smoke inside its time; four cards run all 24
HYBRID_DENSE_LAYERS = {"gloo": 8, "nccl": 24}


def hybrid_placement(torch, env):
    """(device, backend, transport) the ranks take on this machine and
    the phase's first line."""
    dev, backend, transport = env.placement(HYBRID_RANKS)
    cards = torch.cuda.device_count() if backend == "nccl" else 1
    how = ("NCCL, one rank a card" if backend == "nccl" else
           "gloo, staged collectives and p2p through pinned host memory")
    return (dev, backend, transport), (
        f"[hybrid-parallel training: {HYBRID_RANKS} ranks on {cards} "
        f"card{'s' if cards > 1 else ''}, {how}]")


def check_hybrid_shapes(torch, fa, fc):
    """The kernels at the shapes only the hybrid path gives them, against
    their plain twins: flash forward and backward over a rank's 8 heads
    (GPT-1.3B at mp 2: [1, 2048, 8, 128] bf16, causal); the CE forward on
    a vocab shard [2048, 25152] with shard-local labels (a quarter of them
    outside the shard, picking 0) and the backward fed the GLOBAL lse of
    the whole row (softmax_global - onehot_local).  Returns the worst
    errors by kernel name."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    B, T, H, D = 1, 2048, 8, 128
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = fa._plain_fwd(q, k, v, True)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, True)
    ref = fa._plain_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    err = {"flash_attention_fwd": (out.float() - ref_out.float()).abs()
           .max().item(),
           "flash_attention_bwd_dq": (dq.float() - ref[0].float()).abs()
           .max().item(),
           "flash_attention_bwd_dkv": max((a.float() - b.float()).abs().max()
                                          .item() for a, b in
                                          zip((dk, dv), ref[1:]))}
    ok = (torch.allclose(out.float(), ref_out.float(), atol=BF16_TOL,
                         rtol=BF16_TOL)
          and all(torch.allclose(a.float(), b.float(), atol=BF16_TOL,
                                 rtol=BF16_TOL)
                  for a, b in zip((dq, dk, dv), ref)))
    N, V, Vl = 2048, 50304, 25152
    x = (2 * torch.randn(N, V, generator=gen, device="cuda")).bfloat16()
    y = torch.randint(0, V, (N,), generator=gen, device="cuda")
    shard = x[:, Vl:].contiguous()            # rank 1 of mp 2
    local = y - Vl                            # labels below the shard: < 0
    dl = torch.full((N,), 1.0 / N, device="cuda")
    loss, lse_r = fc.ce_fwd(shard, local)
    ref_loss, ref_lse_r = fc._plain_ce_fwd(shard, local)
    lse_g = torch.logsumexp(x.float(), dim=-1)
    dx = fc.ce_bwd(shard, local, lse_g, dl)
    ref_dx = fc._plain_ce_bwd(shard, local, lse_g, dl)
    torch.cuda.synchronize()
    err["fused_ce_fwd"] = max((loss - ref_loss).abs().max().item(),
                              (lse_r - ref_lse_r).abs().max().item())
    err["fused_ce_bwd"] = (dx.float() - ref_dx.float()).abs().max().item()
    ok = ok and err["fused_ce_fwd"] <= LSE_TOL and torch.allclose(
        dx.float(), ref_dx.float(), atol=CE_DX_ATOL, rtol=BF16_TOL)
    log(f"  at the hybrid path's shapes (flash B={B} T={T} H={H} D={D} "
        f"bf16 causal; CE shard N={N} V/mp={Vl}, {int((local < 0).sum())} "
        f"labels outside it, backward on the global lse): max|kernel - "
        f"plain| {json.dumps({n: float(f'{e:.3g}') for n, e in err.items()})}"
        f" (tol {BF16_TOL}*(1+|plain|); lse/loss {LSE_TOL}; dlogits "
        f"{CE_DX_ATOL} + {BF16_TOL}*|plain|)")
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin at the "
                             "hybrid path's shapes")
    return err


def _np_get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict)
                else v.detach().float().cpu().numpy())
            for k, v in tree.items()}


def _one_card_run(torch, gpt_hybrid, optim, clip, cfg, master, batches,
                  clip_norm):
    """The one-card step (mesh None) on the card: (losses, {name:
    final param on the CPU})."""
    opt = optim.AdamW(learning_rate=TRAIN_LR, grad_clip=(
        clip.ClipGradByGlobalNorm(clip_norm) if clip_norm else None))
    init_fn, step_fn, _ = gpt_hybrid.build_gpt_train_step(cfg, opt,
                                                          device="cuda")
    st = init_fn(params=_to_card(master))
    losses = []
    for b in batches:
        st, loss = step_fn(st, b, None, TRAIN_LR)
        losses.append(loss.item())
    return losses, {n: t.cpu() for n, t in _leaves(st.params)}


def _launch_gates(rank_outs, want_of, what):
    """Every rank's launches, step by step, against ``want_of(coords)``;
    returns the launches summed over ranks and steps."""
    total: dict = {}
    for r in rank_outs:
        want = want_of(r["coords"])
        for i, got in enumerate(r["launches"]):
            if got != want:
                raise AssertionError(f"{what}: rank {r['rank']} "
                                     f"{r['coords']} step {i + 1} launched "
                                     f"{got}, not {want}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
    return total


def _add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def _small_cfg(torch, gpt, over):
    from paddle_tpu_torch.text import moe

    over = dict(over)
    if "moe" in over:
        over["moe"] = moe.MoEConfig(**over["moe"])
    return gpt.GPTConfig(**{**HYBRID_BASE, **over}, dtype=torch.float32)


def _ring_cases():
    """(e) as cases of ``hybrid_check``'s "ring" kind: q, k, v and the
    cotangent drawn on each rank's card from seed 23, both routes."""
    return [{"kind": "ring", "mesh": mesh, "zigzag": zig,
             "gen": (1, 2048, H, H, 128, 23), "dtype": "bfloat16",
             "routes": ("kernel", "plain")}
            for _, mesh, H, zig in HYBRID_RING_SHAPES]


def check_ring_shapes(ra, outs):
    """(e): each rank's kernel-route launches of #1-#3 exactly
    ``ring_attention.launches`` and all on the tensor-core bodies; the
    gathered output within BF16_TOL * (1 + |plain|) of the plain route's
    (the lse merge is a convex sum of bf16 partials), dq, dk and dv
    within BF16_TOL * (max|plain| + |plain|): flash's backward takes δ
    from the bf16 output, as on one card, so a row that sees few keys
    moves by a bf16 step of the tensor's large entries, where the plain
    route differentiates the fp32 math.  Returns (per-shape stats, the
    worst errors by kernel)."""
    stats, worst = {}, {}
    for i, (name, mesh, H, zig) in enumerate(HYBRID_RING_SHAPES):
        R = mesh["sp"]
        layout = "zigzag" if zig else "causal"
        for rank, o in enumerate(outs):
            r = o[i]["kernel"]
            # sp is the mesh's major axis: rank // (world / R) is the
            # rank's sp coordinate
            n = ra.launches(layout, R, rank // (len(outs) // R))
            want = {k: n for k in r["launches"]}
            if r["launches"] != want or r["tc_launches"] != want:
                raise AssertionError(
                    f"ring {name}: rank {rank} launched {r['launches']} "
                    f"(tc {r['tc_launches']}), not {n} each")
        k, p = outs[0][i]["kernel"], outs[0][i]["plain"]
        err = {}
        for t in ("out", "dq", "dk", "dv"):
            e = float(np.abs(k[t] - p[t]).max())
            err[t] = e
            scale = 1.0 if t == "out" else float(np.abs(p[t]).max())
            if not np.allclose(k[t], p[t], atol=BF16_TOL * scale,
                               rtol=BF16_TOL):
                raise AssertionError(f"ring {name}: the kernel route's {t} "
                                     f"is {e} from the plain twin's")
        worst["flash_attention_fwd"] = max(worst.get(
            "flash_attention_fwd", 0.0), err["out"])
        worst["flash_attention_bwd_dq"] = max(worst.get(
            "flash_attention_bwd_dq", 0.0), err["dq"])
        worst["flash_attention_bwd_dkv"] = max(worst.get(
            "flash_attention_bwd_dkv", 0.0), err["dk"], err["dv"])
        stats[name] = {
            "max_abs_err": err,
            "kernel_ms": [round(o[i]["kernel"]["ms"], 3) for o in outs],
            "plain_ms": [round(o[i]["plain"]["ms"], 3) for o in outs],
            "launches_a_rank": [o[i]["kernel"]["launches"][
                "flash_attention_fwd"] for o in outs]}
        log(f"  (e) ring {name}, B=1 T=2048 H={H} D=128 bf16: kernel - "
            f"plain max|.| {json.dumps({t: float(f'{e:.3g}') for t, e in err.items()})}"
            f" (tol {BF16_TOL}*(1+|plain|); grads {BF16_TOL}*(max|plain|+"
            f"|plain|)); #1/#2/#3 a rank "
            f"{stats[name]['launches_a_rank']} (all tc); fwd+bwd ms a rank "
            f"kernel {stats[name]['kernel_ms']}, plain "
            f"{stats[name]['plain_ms']}")
    return stats, worst


def hybrid_small(torch, gpt, gpt_hybrid, optim, clip, spawn, hc, env,
                 steps, extra=()):
    """(a) and (d): ``steps`` (HYBRID_SMALL_STEPS) AdamW steps of the
    small fp32 models on every mesh of ``HYBRID_SMALL_RUNS`` and
    ``HYBRID_SP_RUNS`` (CE and LN flags on), all in one spawn of the
    ranks, against the one-card step (mesh None) on the card from the
    same seed-7 masters and batches: losses
    within TRAIN_LOSS_TOL, the gathered final params within
    TRAIN_PARAM_TOL but for a TRAIN_PARAM_FAR share (all within
    steps * TRAIN_LR), each rank's launches of #1-#7 exactly
    ``hc.expected_hybrid_launches`` (under sp: the ring's kernel route);
    on mp 4 the vocab-parallel CE's kernel route against its plain twin
    (loss within LSE_TOL, dlogits within CE_DX_ATOL + BF16_TOL * |plain|);
    and (e), ``check_ring_shapes``.  ``extra`` cases run in the same spawn
    after them (the data and comm phase's (c), the PS phase's (d), the
    full-width arms).
    Returns (stats, launches of (a), their tc launches, launches of (d),
    their tc launches, the ring's worst errors, each rank's results of
    ``extra``)."""
    from paddle_tpu_torch.ops import ring_attention as ra

    rng = np.random.default_rng(3)
    batches = [rng.integers(0, HYBRID_BASE["vocab_size"], (4, 65))
               for _ in range(steps)]
    runs = HYBRID_SMALL_RUNS + HYBRID_SP_RUNS
    cfgs, masters, refs, cases = {}, {}, {}, []
    os.environ.update(HYBRID_FLAGS)
    for name, over, mesh, kw, clip_norm in runs:
        key = repr(sorted(over.items()))
        if key not in cfgs:
            cfgs[key] = _small_cfg(torch, gpt, over)
            masters[key] = gpt.init_master_params(cfgs[key], seed=7,
                                                  device="cpu")
        if (key, clip_norm) not in refs:
            refs[key, clip_norm] = _one_card_run(
                torch, gpt_hybrid, optim, clip, cfgs[key], masters[key],
                batches, clip_norm)
        cases.append({"kind": "train", "cfg": cfgs[key], "mesh": mesh,
                      "kw": kw, "clip": clip_norm,
                      "params": _np_tree(masters[key]), "batches": batches,
                      "lr": TRAIN_LR, "flags": HYBRID_FLAGS})
    g = np.random.default_rng(5)
    V = 2048
    cases.append({"kind": "megatron", "mesh": {"mp": HYBRID_RANKS},
                  "flags": HYBRID_FLAGS,
                  "wte": g.standard_normal((V, 64)).astype(np.float32),
                  "tokens": g.integers(0, V, (4, 9)),
                  "x": g.standard_normal((4, 32)).astype(np.float32),
                  "w": g.standard_normal((32, 16)).astype(np.float32),
                  "b": g.standard_normal(16).astype(np.float32),
                  "logits": (5 * g.standard_normal((4, 64, V))).astype(
                      np.float32),
                  "targets": g.integers(0, V, (4, 64))})
    ring = _ring_cases()
    cases += ring + list(extra)
    t0 = time.perf_counter()
    with shared_card_allocator(hybrid_placement(torch, env)[0][1]):
        outs = spawn.spawn(hc.run_cases, (cases,), nprocs=HYBRID_RANKS)
    wall = time.perf_counter() - t0
    n_extra = len(extra)
    total, tc_total, sp_total, sp_tc = {}, {}, {}, {}
    worst_loss = worst_param = 0.0
    failed = []
    for i, (name, over, mesh, kw, clip_norm) in enumerate(runs):
        key = repr(sorted(over.items()))
        ref_losses, ref_params = refs[key, clip_norm]
        ranks = [o[i] for o in outs]
        got = ranks[0]
        d_loss = max(abs(a - b) for a, b in zip(got["losses"], ref_losses))
        diff = np.concatenate([
            np.abs(_np_get(got["params"], n) - t.numpy()).ravel()
            for n, t in ref_params.items()])
        far = float((diff > TRAIN_PARAM_TOL).mean())
        cfg = cfgs[key]
        new = i >= len(HYBRID_SMALL_RUNS)
        total_run = _launch_gates(
            ranks, lambda c: hc.expected_hybrid_launches(
                cfg, mesh, kw.get("n_micro", 1), 1, c.get("pp", 0),
                fused_ln=True, fused_ce=True, sp_rank=c.get("sp", 0),
                zigzag=kw.get("sp_zigzag", False)), name)
        _add(sp_total if new else total, total_run)
        for r in ranks:
            for t in r["tc_launches"]:
                _add(sp_tc if new else tc_total, t)
        comm = got["comm"][-1]
        routed = "moe" in over and "sp" in mesh
        d_first = abs(got["losses"][0] - ref_losses[0])
        log(f"  {'(d) ' if new else ''}{name}: losses "
            f"{[round(x, 5) for x in got['losses']]}"
            f"{'' if d_loss <= TRAIN_LOSS_TOL else f' (one card {[round(x, 5) for x in ref_losses]})'}; "
            f"max|loss - one card| {d_loss:.3g} (tol {TRAIN_LOSS_TOL}"
            f"{f'; step 1 {d_first:.3g}, later {HYBRID_ROUTED_TOL}' if routed else ''}); "
            f"params - one card: max {diff.max():.3g} (tol "
            f"{steps * TRAIN_LR}), share past {TRAIN_PARAM_TOL} "
            f"{far:.3g} of {diff.size} (tol {TRAIN_PARAM_FAR}); rank 0 "
            f"launches a step {got['launches'][-1]}; collectives a step "
            f"(rank 0) {json.dumps(comm)}")
        if routed:
            ok = d_first <= TRAIN_LOSS_TOL and d_loss <= HYBRID_ROUTED_TOL
        else:
            ok = (d_loss <= TRAIN_LOSS_TOL and far <= TRAIN_PARAM_FAR
                  and diff.max() <= steps * TRAIN_LR)
            worst_loss = max(worst_loss, d_loss)
            worst_param = max(worst_param, float(diff.max()))
        if not (all(map(math.isfinite, got["losses"])) and ok):
            failed.append(f"hybrid {name} disagrees with the one-card step")
    mg = outs[0][len(runs)]
    e_loss = float(np.abs(mg["ce_kernel"] - mg["ce_plain"]).max())
    e_grad = float(np.abs(mg["ce_kernel_grad"] - mg["ce_plain_grad"]).max())
    grad_ok = np.allclose(mg["ce_kernel_grad"], mg["ce_plain_grad"],
                          atol=CE_DX_ATOL, rtol=BF16_TOL)
    log(f"  vocab-parallel CE on mp {HYBRID_RANKS} (fp32 [256, {V}] logits): "
        f"kernel route - plain twin: loss {e_loss:.3g} (tol {LSE_TOL}), "
        f"dlogits {e_grad:.3g}")
    if not (e_loss <= LSE_TOL and grad_ok):
        failed.append("the vocab-parallel CE's kernel route disagrees with "
                      "its plain twin")
    ring_stats, ring_err = check_ring_shapes(
        ra, [o[len(runs) + 1:len(runs) + 1 + len(ring)] for o in outs])
    if failed:
        raise AssertionError("; ".join(failed))
    for k in HYBRID_FLAGS:
        os.environ.pop(k, None)
    return ({"runs": len(runs), "worst_loss": worst_loss,
             "worst_param": worst_param, "spawn_wall_s": wall,
             "vocab_parallel_ce": {"loss": e_loss, "dlogits": e_grad},
             "ring_shapes": ring_stats},
            total, tc_total, sp_total, sp_tc, ring_err,
            [o[len(o) - n_extra:] if n_extra else [] for o in outs])


def headline_step1_loss(torch, gpt, tr):
    """The headline rung's step-1 loss without its step: the mean of its
    8 micro-batch losses on the seed-0 masters (what its step reports)."""
    cfg, opt, init_fn, step_fn, tokens = tr.build_train_path(
        "cuda", seed=0, rung=HYBRID_1P3B_RUNG)
    params = gpt.init_master_params(cfg, 0, "cuda")
    r = tr.RUNGS[HYBRID_1P3B_RUNG]
    inv = 1.0 / r.accum
    loss = torch.zeros((), device="cuda")
    with torch.no_grad():
        for t in tokens.reshape(r.accum, -1, tokens.shape[-1]):
            loss = loss + gpt.loss_fn(params, t, cfg) * inv
    out = loss.item()
    del params
    for k in r.flags:
        os.environ.pop(k, None)
    return out


def one_card_loss(torch, gpt, tr, rung, rows, key=None, over=None):
    """The one-card step's loss on the first ``rows`` rows of ``rung``'s
    batch, without its step: the seed-0 masters of its config (fields
    ``over`` replaced) drawn on the card, the rung's flags, forward only
    — a dense model row by row (the mean of equal rows' means), an MoE
    model on all rows at once (one routing set, as its step routes
    them)."""
    r = tr.RUNGS[rung]
    cfg = gpt.GPTConfig(**{**r.cfg, **(over or {})})
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (r.batch, tr.SEQ + 1))[:rows], device="cuda")
    os.environ.update(r.flags)
    params = gpt.init_master_params(cfg, 0, "cuda")
    with torch.no_grad():
        if cfg.moe is not None:
            loss = gpt.loss_fn(params, toks, cfg, key=key).item()
        else:
            loss = sum(gpt.loss_fn(params, t[None], cfg).item()
                       for t in toks) / rows
    del params
    for k in r.flags:
        os.environ.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def hybrid_1p3b_arms(torch, gpt, tr, backend, headline):
    """The full-width arms: (name, rung, config fields over the rung's,
    mesh, step kwargs, rows of the batch, key, the one-card loss on those
    rows).  (b) pp2 x mp2; (f) sp2 x mp2 in both layouts and the MoE
    rung's model under ep (ep4 on one card at HYBRID_MOE_LAYERS' depth,
    dp2 x ep2 on four); with four cards also sp4 zigzag and (c).  The
    dense arms run HYBRID_DENSE_LAYERS deep (one card: 8, each held to
    the one-card loss of its rows at that depth)."""
    rows = HYBRID_SP_ROWS[backend]
    r = tr.RUNGS[HYBRID_1P3B_RUNG]
    layers = HYBRID_DENSE_LAYERS[backend]
    cut = layers != r.cfg["num_layers"]
    over = {"num_layers": layers} if cut else {}
    deep = f" ({layers} layers)" if cut else ""
    pp_ref = (one_card_loss(torch, gpt, tr, HYBRID_1P3B_RUNG, r.batch,
                            over=over) if cut else headline)
    dense = (headline if rows == r.batch and not cut else
             one_card_loss(torch, gpt, tr, HYBRID_1P3B_RUNG, rows,
                           over=over))
    moe_mesh = {"dp": 2, "ep": 2} if backend == "nccl" else {"ep": 4}
    moe_over = {"num_layers": HYBRID_MOE_LAYERS[backend]}
    moe_loss = one_card_loss(torch, gpt, tr, HYBRID_MOE_RUNG, rows, tr.KEY,
                             moe_over)
    arms = [("pp2 x mp2 1f1b M=8" + deep, HYBRID_1P3B_RUNG, over,
             {"pp": 2, "mp": 2}, {"n_micro": 8}, 8, None, pp_ref),
            ("sp2 x mp2" + deep, HYBRID_1P3B_RUNG, over, {"sp": 2, "mp": 2},
             {}, rows, None, dense),
            ("sp2 x mp2 zigzag" + deep, HYBRID_1P3B_RUNG, over,
             {"sp": 2, "mp": 2}, {"sp_zigzag": True}, rows, None, dense),
            ("moe " + " x ".join(f"{a}{n}" for a, n in moe_mesh.items())
             + f" ({moe_over['num_layers']} layers)", HYBRID_MOE_RUNG,
             moe_over, moe_mesh, {}, rows, tr.KEY, moe_loss)]
    if backend == "nccl":
        arms += [("sp4 zigzag", HYBRID_1P3B_RUNG, {}, {"sp": 4},
                  {"sp_zigzag": True}, rows, None, dense),
                 ("dp2 x mp2 zero 1 accum 4", HYBRID_1P3B_RUNG, {},
                  {"dp": 2, "mp": 2}, {"zero": 1, "accum": 4}, 8, None,
                  headline)]
    return arms


def hybrid_1p3b_cases(torch, gpt, tr, headline, placement):
    """(b) and (f)'s rank cases and, last, the full-width pipeline's: (the
    arms, the cases) for ``hybrid_check.run_cases``; see
    ``hybrid_1p3b``."""
    (dev, backend, transport), _ = placement
    arms = hybrid_1p3b_arms(torch, gpt, tr, backend, headline)
    toks = np.random.default_rng(0).integers(
        0, gpt.gpt_1p3b().vocab_size,
        (tr.RUNGS[HYBRID_1P3B_RUNG].batch, tr.SEQ + 1))
    opt = ("AdamW", {"learning_rate": tr.LR,
                     "weight_decay": tr.WEIGHT_DECAY,
                     "state_dtype": torch.bfloat16})
    steps = HYBRID_1P3B_STEPS[backend]
    cases = [{"kind": "train",
              "cfg": gpt.GPTConfig(**{**tr.RUNGS[rung].cfg, **over}),
              "mesh": mesh, "kw": kw, "seed": 0, "batches": [toks[:rows]],
              "steps": steps, "lr": tr.LR, "opt": opt,
              "key": key, "flags": dict(tr.RUNGS[rung].flags),
              "gather": False, "profile_last": steps > 2,
              "stagger_init": True}
             for _, rung, over, mesh, kw, rows, key, _ in arms]
    cases.append(pipeline_1p3b_case(torch, gpt, tr, backend, toks))
    return arms, cases


@contextlib.contextmanager
def shared_card_allocator(backend):
    """Ranks sharing a card: the allocator grows segments in place rather
    than caching a freed block per size (less memory held unused) — set
    for the ranks a spawn starts in the block."""
    with env_set(PYTORCH_CUDA_ALLOC_CONF=(
            os.environ.get("PYTORCH_CUDA_ALLOC_CONF") if backend == "nccl"
            else "expandable_segments:True")):
        yield


def hybrid_1p3b(torch, gpt, tr, hc, arms, cases, outs, placement, wall):
    """(b) and (f): GPT-1.3B (``gpt.gpt_1p3b()``) at pp2 x mp2, 1F1B, 8
    micro-batches, on the headline rung's batch (8 x 2048 tokens, seed 0),
    masters and optimizer (AdamW, bf16 moments), both fused flags; at sp2
    x mp2 in both layouts on the batch's first HYBRID_SP_ROWS rows; the
    MoE rung's model (``HYBRID_MOE_RUNG``, its key) under ep; with four
    cards also sp4 zigzag and (c) dp2 x mp2 under ZeRO 1 at accum 4.
    Steps 1-2: step 1's loss within HYBRID_1P3B_LOSS_TOL of the one-card
    step's on the same rows (``one_card_loss``; the headline rung's for
    the whole batch), every rank's launches exact (the flash kernels on
    their tensor-core bodies; under sp the ring's kernel route); the loss
    falls (step 2 below step 1: without warm-up the 1.3B loss overshoots
    at step 3); on four cards step 3 profiled on every rank (device time
    by family, the collectives' share).  Prints each rank's step ms, peak
    memory and collective bytes; tokens/s and MFU (JAX's FLOP count over
    the cards' bf16 peak) of step 2.  ``arms`` and ``cases`` are
    ``hybrid_1p3b_cases``', ``outs`` each rank's results of ``cases``
    (the full-width pipeline's last), ``wall`` their spawn's
    seconds.  Returns (stats, launches of (b) and (c), their tc launches,
    launches of (f), their tc launches, the pipeline's launches and tc
    launches)."""
    (dev, backend, transport), _ = placement
    cards = torch.cuda.device_count() if backend == "nccl" else 1
    shared = "" if backend == "nccl" else (
        f" (the {HYBRID_RANKS} ranks share one card: these times measure "
        f"the sharing)")
    stats, total, tc_total, new_total, new_tc = {}, {}, {}, {}, {}
    failed = []
    for i, (name, rung, _, mesh, kw, rows, key, ref) in enumerate(arms):
        cfg = cases[i]["cfg"]
        n_tok = rows * tr.SEQ
        fpt = gpt.flops_per_token(cfg, tr.SEQ)
        new = "sp" in mesh or cfg.moe is not None
        ranks = [o[i] for o in outs]
        losses = ranks[0]["losses"]
        gated = 2
        _add(new_total if new else total, _launch_gates(
            [dict(x, launches=x["launches"][:gated]) for x in ranks],
            lambda c: hc.expected_hybrid_launches(
                cfg, mesh, kw.get("n_micro", 1), kw.get("accum", 1),
                c.get("pp", 0), sp_rank=c.get("sp", 0),
                zigzag=kw.get("sp_zigzag", False)), name))
        for x in ranks:
            for j, tc in enumerate(x["tc_launches"][:gated]):
                want = {k: x["launches"][j][k] for k in tc}
                if tc != want:
                    raise AssertionError(f"{name}: rank {x['rank']} step "
                                         f"{j + 1} tensor-core launches {tc}"
                                         f", not {want}")
                _add(new_tc if new else tc_total, tc)
        step_s = ranks[0]["step_ms"][1] / 1e3
        per_rank = [{
            "rank": x["rank"], "coords": x["coords"],
            "step_ms": x["step_ms"], "peak_gb": x["peak_gb"],
            "collective_bytes_step2": {k: v["bytes"] for k, v in
                                       x["comm"][1].items()},
            "collective_calls_step2": {k: v["calls"] for k, v in
                                       x["comm"][1].items()},
            "profiled_step3": x["profile"] and {k: x["profile"][k] for k in (
                "wall_ms", "device_ms", "device_busy_share",
                "collective_share", "device_ms_by_family")}}
            for x in ranks]
        rec = {"mesh": mesh, **kw, "rung": rung, "rows": rows,
               "backend": backend, "transport": transport, "cards": cards,
               "losses": losses, "one_card_step1_loss": ref,
               "tokens_per_s": n_tok / step_s,
               "mfu": fpt * n_tok / step_s / (cards * BF16_FLOPS_PER_S),
               "ranks": per_rank}
        for x in per_rank:
            prof = x["profiled_step3"]
            log(f"  {name} rank {x['rank']} {x['coords']}: step ms "
                f"{[round(m, 1) for m in x['step_ms']]}{shared}, peak "
                f"{x['peak_gb']:.2f} GB, collective bytes a step "
                f"{json.dumps(x['collective_bytes_step2'])}"
                + (f", profiled step: device {prof['device_ms']} ms, busy "
                   f"{prof['device_busy_share']}, collectives' share "
                   f"{prof['collective_share']}" if prof else ""))
        log(f"  {name} ({rows} x {tr.SEQ + 1} tokens): losses "
            f"{[round(x, 5) for x in losses]} (one-card step 1 {ref:.5f}, "
            f"tol {HYBRID_1P3B_LOSS_TOL}); step 2 {step_s * 1e3:.1f} ms, "
            f"{rec['tokens_per_s']:.0f} tokens/s, MFU {rec['mfu']:.4f} over "
            f"{cards} card(s){shared}")
        # at lr 2e-4 without warm-up the 1.3B loss overshoots at step 3
        # (the headline rung's 11.23, 10.95, 11.83): it falls at step 2
        falls = losses[1] < losses[0]
        if not (all(map(math.isfinite, losses))
                and abs(losses[0] - ref) <= HYBRID_1P3B_LOSS_TOL and falls):
            failed.append(f"{name}: losses {losses} against the one-card "
                          f"step 1 {ref}")
        stats[name] = rec
    stats["spawn_wall_s"] = wall
    if failed:
        raise AssertionError("; ".join(failed))
    stats["pipeline"], pipe_l, pipe_tc = check_pipeline_1p3b(
        torch, gpt, tr, hc, cases[-1], [o[len(arms)] for o in outs],
        backend)
    return stats, total, tc_total, new_total, new_tc, pipe_l, pipe_tc


def hybrid_phase(torch, gpt, gpt_hybrid, optim, clip, tr, fa, fc, headline,
                 small_runs=True, ps_case=None):
    """The hybrid-parallel phase: the kernels at its shapes in this
    process, then (a)-(f) in ranks spawned from it — the libraries already
    built here, so the ranks only load them; ``small_runs=False`` runs
    the full-width arms alone.  Everything runs in one spawn of the
    ranks: (a), (d), (e), the data and comm phase's rank cases (c), the
    PS phase's (d) (``ps_case``: its rank results come back under
    stats["ps_sharded"], popped by the caller), then (b), (f) and the
    full-width pipeline.
    Returns (stats, launches by kernel summed over ranks of (a)-(c),
    their tensor-core launches, the same of the sp / ep runs (d) and
    (f), the kernels' errors at the hybrid shapes and on the ring); the
    data and comm cases' launches are in stats["data_comm_launches"] and
    ["data_comm_tc_launches"]."""
    from paddle_tpu_torch.distributed import env, spawn
    from paddle_tpu_torch.distributed.fleet import comm_opt as co
    from paddle_tpu_torch.tools import hybrid_check as hc

    t0 = time.perf_counter()
    placement = hybrid_placement(torch, env)
    log(placement[1])
    err, small, total, tc_total, sp_total, sp_tc = {}, None, {}, {}, {}, {}
    comm, comm_l, comm_tc, ps_ranks = None, {}, {}, None
    arms, big = hybrid_1p3b_cases(torch, gpt, tr, headline, placement)
    if small_runs:
        err = check_hybrid_shapes(torch, fa, fc)
        steps = HYBRID_SMALL_STEPS[placement[0][1]]
        comm_cases, comm_ctx = comm_small_cases(torch, gpt, steps)
        extra = comm_cases + ([ps_case] if ps_case is not None else [])
        t_spawn = time.time()
        small, total, tc_total, sp_total, sp_tc, ring_err, tail = \
            hybrid_small(torch, gpt, gpt_hybrid, optim, clip, spawn, hc, env,
                         steps, extra + big)
        for k, e in ring_err.items():
            err[k] = max(err.get(k, 0.0), e)
        log(f"  (a) (d) (e) {json.dumps(small)}")
        n = len(comm_cases)
        comm, comm_l, comm_tc = check_comm_small(
            torch, gpt_hybrid, optim, clip, hc, co, comm_ctx,
            [t[:n] for t in tail])
        if ps_case is not None:
            ps_ranks = {"rank0": tail[0][n], "spawn_wall_clock": t_spawn}
        outs = [t[len(extra):] for t in tail]
        wall = small["spawn_wall_s"]
    else:
        t1 = time.perf_counter()
        with shared_card_allocator(placement[0][1]):
            outs = spawn.spawn(hc.run_cases, (big,), nprocs=HYBRID_RANKS)
        wall = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    big_stats, t2, tc2, t3, tc3, pipe_l, pipe_tc = hybrid_1p3b(
        torch, gpt, tr, hc, arms, big, outs, placement, wall)
    _add(total, t2)
    _add(tc_total, tc2)
    _add(sp_total, t3)
    _add(sp_tc, tc3)
    _add(comm_l, pipe_l)
    _add(comm_tc, pipe_tc)
    stats = {"placement": placement[1], "small": small,
             "gpt_1p3b": big_stats,
             "sp_ep_launches": sp_total, "sp_ep_tc_launches": sp_tc,
             "data_comm_small": comm, "data_comm_launches": comm_l,
             "data_comm_tc_launches": comm_tc, "ps_sharded": ps_ranks,
             "phase_s": time.perf_counter() - t0}
    log(f"  the sp / ep runs' launches (d) + (f), all ranks: "
        f"{json.dumps(sp_total)}; on tensor cores {json.dumps(sp_tc)}")
    log(f"[hybrid-parallel phase: {stats['phase_s']:.1f} s]")
    return stats, total, tc_total, sp_total, sp_tc, err


# -- data ingestion, DGC, LocalSGD and the functional pipeline -------------

# (a): the headline rung fed from token shards on disk
DATA_SHARDS = 4
DATA_SHARD_RECORDS = 2048        # 2048 x 2049 int32 tokens: 16.8 MB a shard
DATA_STEPS = 4
DATA_THREADS = (1, 4)
# (b): DGC at full width, the reference's defaults
DGC_SPARSITY, DGC_MOMENTUM = 0.99, 0.9
DGC_ROUNDS = 2
# the sends' mean over dp against one card's mean of the ranks' sends
DGC_AXIS_RTOL = 1e-6
# (c): the rank cases
LOCALSGD_K, LOCALSGD_STEPS = 4, 8
# (name, mesh, micro-batches, remat_stage) on the small fp32 model at 4
# layers (HYBRID_BASE's widths).  Every mesh of the spawn spans its four
# ranks, so pp2 runs as dp2 x pp2 (pp2 alone is held in the CPU tests)
PIPE_SMALL_RUNS = (("pipeline pp4 M=4 remat", {"pp": 4}, 4, True),
                   ("pipeline dp2 x pp2 M=2 remat", {"dp": 2, "pp": 2}, 2,
                    True),
                   ("pipeline dp2 x pp2 M=4", {"dp": 2, "pp": 2}, 4, False))
PIPE_SMALL_LAYERS = 4
# GPT-1.3B's widths at dp2 x pp2, M = 2, on the headline batch's first 4
# rows: one card (four gloo ranks sharing it, staged) at 4 layers, four
# cards (NCCL) at all 24
PIPE_1P3B_ROWS = 4
PIPE_1P3B_LAYERS = {"gloo": 4, "nccl": 24}
PIPE_1P3B_STEPS = 2


def write_token_shards(d, head, filler_seed=1):
    """DATA_SHARDS files of DATA_SHARD_RECORDS records each (the shard
    format: int32 tokens, one row of ``head.shape[1]`` a record): the
    first begins with the rows of ``head`` DATA_STEPS times — the batches
    the steps take, in the order one reader thread delivers them — and
    every shard is filled to its size with seeded tokens.  Returns (the
    paths, every record written, in file order)."""
    rng = np.random.default_rng(filler_seed)
    W = head.shape[1]
    files, rows = [], []
    for i in range(DATA_SHARDS):
        lead = np.concatenate([head] * DATA_STEPS) if i == 0 else \
            head[:0]
        fill = rng.integers(0, 50304, (DATA_SHARD_RECORDS - len(lead), W),
                            dtype=np.int32)
        arr = np.ascontiguousarray(np.concatenate([lead, fill]), np.int32)
        p = os.path.join(d, f"tokens_{i:02d}.bin")
        arr.tofile(p)
        files.append(p)
        rows.append(arr)
    return files, np.concatenate(rows)


def reader_rate(nr, files, W, batch, threads, written):
    """The reader alone over every shard: (records/s, records, ok) — one
    thread delivers ``written`` in order; more, its multiset."""
    t0 = time.perf_counter()
    got = list(nr.TokenShardReader(files, W, batch, num_threads=threads))
    wall = time.perf_counter() - t0
    recs = np.concatenate(got)
    if threads == 1:
        ok = np.array_equal(recs, written)
    else:
        ok = (len(recs) == len(written) and
              sorted(map(bytes, recs)) == sorted(map(bytes, written)))
    return len(recs) / wall, len(recs), ok


def reader_fed_headline(torch, gpt, tr, ks, remat_policies, in_memory):
    """(a): DATA_STEPS steps of the headline rung from the same init, fed
    by ``QueueDataset`` -> ``TokenShardReader(num_threads=1)`` ->
    ``DevicePrefetcher(depth=2)`` over shards written from its batch;
    ``in_memory`` the in-memory run's stats (``train_path``'s).  Gates:
    every delivered batch equals the in-memory batch bit for bit; the
    losses equal the in-memory run's; #1-#7 launch exactly the headline's
    a step.  Then the reader alone at DATA_THREADS over the 64 MB."""
    import tempfile

    from paddle_tpu_torch.distributed.fleet.dataset import QueueDataset
    from paddle_tpu_torch.io import native_reader as nr

    rung = HYBRID_1P3B_RUNG
    r = tr.RUNGS[rung]
    cfg, opt, init_fn, step_fn, tokens = tr.build_train_path(
        "cuda", seed=0, rung=rung)
    head = tokens.cpu().numpy().astype(np.int32)
    W = head.shape[1]
    want = expected_train_launches(cfg, r, remat_policies)
    out = {}
    with tempfile.TemporaryDirectory(prefix="token_shards_") as d:
        t0 = time.perf_counter()
        files, written = write_token_shards(d, head)
        out["shards_written_s"] = time.perf_counter() - t0
        out["shard_bytes"] = [os.path.getsize(f) for f in files]
        ds = QueueDataset()
        ds.set_filelist(files)
        ds.set_record_schema(W, np.int32)
        ds.set_batch_size(r.batch)
        ds.set_thread(1)
        state = init_fn(0)
        torch.cuda.synchronize()
        pf = nr.DevicePrefetcher(iter(ds), depth=2)
        it = iter(pf)
        losses, step_ms, depth, per_step, equal = [], [], [], [], []
        n_tok = r.batch * tr.SEQ
        for _ in range(DATA_STEPS):
            depth.append(pf.pending())
            before = launch_counts(ks)
            t0 = time.perf_counter()
            batch = next(it)
            equal.append(bool(torch.equal(batch.long(), tokens)))
            state, loss = step_fn(state, batch, tr.KEY, tr.LR)
            losses.append(loss.item())
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append({n: c - before[n]
                             for n, c in launch_counts(ks).items()})
        pf.close()
        copies = dict(pf.stager.stats)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        rates = {}
        for n in DATA_THREADS:
            rate, recs, ok = reader_rate(nr, files, W, r.batch, n, written)
            rates[n] = {"records_per_s": rate, "records": recs,
                        "in_order" if n == 1 else "multiset_equal": ok}
            if not ok:
                raise AssertionError(f"the reader at {n} thread(s) did not "
                                     f"deliver the records written")
    steady = statistics.median(step_ms[1:])
    ref = in_memory["losses"]
    out.update(losses=losses, in_memory_losses=ref, step_ms=step_ms,
               steady_step_ms=steady,
               in_memory_steady_step_ms=in_memory["steady_step_ms"],
               steady_tokens_per_s=n_tok / (steady / 1e3),
               queue_depth_before_step=depth, batches_equal=equal,
               launches_per_step=per_step[-1], stager=copies,
               reader=rates)
    log(f"  (a) reader-fed headline: losses {[round(x, 6) for x in losses]} "
        f"(in memory {[round(x, 6) for x in ref]}); step ms "
        f"{[round(x, 1) for x in step_ms]}, steady {steady:.1f} against "
        f"{in_memory['steady_step_ms']:.1f} in memory "
        f"({steady / in_memory['steady_step_ms']:.4f}x); queue depth before "
        f"each step {depth}; batches equal {equal}; stager {copies}; the "
        f"reader alone over {sum(out['shard_bytes']) / 1e6:.1f} MB: "
        + ", ".join(f"{n} thread(s) {v['records_per_s']:.0f} records/s"
                    for n, v in rates.items()))
    if not all(equal):
        raise AssertionError(f"a delivered batch is not the in-memory "
                             f"batch: {equal}")
    if losses != ref:
        raise AssertionError(f"reader-fed losses {losses} are not the "
                             f"in-memory run's {ref}")
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"reader-fed step {i + 1} launched {got}, "
                                 f"not {want}")
    return out


def _dgc_leaf_gate(torch, g, u, v, send, u2, v2, what):
    """One leaf of one round against the DGC law, from the round's inputs
    (g, u, v) and outputs: the kept set by ``kthvalue`` (the function
    finds its threshold by ``topk``); density within 1 - sparsity but for
    ties; send + v' the pre-mask accumulator V = v + (m·u + g); u' and v'
    zero on the kept set and m·u + g and V off it.  Returns (kept, k)."""
    acc = u * DGC_MOMENTUM
    acc.add_(g)
    V = v + acc
    n = V.numel()
    k = max(1, int(n * (1.0 - DGC_SPARSITY)))
    mag = V.abs()
    thr = torch.kthvalue(mag.reshape(-1), n - k + 1).values
    kept = mag >= thr
    above = int((mag > thr).sum())
    n_kept = int(kept.sum())
    del mag
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    ok = (above < k <= n_kept
          and torch.equal(send + v2, V)
          and torch.equal(send, torch.where(kept, V, zero))
          and torch.equal(u2, torch.where(kept, zero, acc))
          and torch.equal(v2, torch.where(kept, zero, V)))
    if not ok:
        raise AssertionError(f"DGC {what}: the round breaks the law (n {n}, "
                             f"k {k}, above the threshold {above}, kept "
                             f"{n_kept})")
    return n_kept, k


def dgc_full_width(torch, gpt, gpt_hybrid, tr, co):
    """(b): the headline rung's fp32 gradients of one batch (8
    micro-batches' mean, fp32 sums) on its seed-0 masters, then DGC_ROUNDS
    ``dgc_compress`` calls on them, the state carried, each timed by CUDA
    events with its peak memory above what it was handed; every leaf of
    every round held to the DGC law (``_dgc_leaf_gate``)."""
    cfg, _, _, _, tokens = tr.build_train_path("cuda", seed=0,
                                               rung=HYBRID_1P3B_RUNG)
    r = tr.RUNGS[HYBRID_1P3B_RUNG]
    params = gpt.init_master_params(cfg, 0, "cuda")
    grads = None
    t0 = time.perf_counter()
    for t in tokens.reshape(r.accum, -1, tokens.shape[-1]):
        _, g = gpt_hybrid.value_and_grad(
            lambda p, x: gpt.loss_fn(p, x, cfg), params, t)
        if grads is None:
            grads = _tree_map(lambda x: x.mul_(1.0 / r.accum), g)
        else:
            for name, x in _leaves(g):
                _np_get(grads, name).add_(x, alpha=1.0 / r.accum)
        del g
    del params
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    n = sum(x.numel() for _, x in _leaves(grads))
    biggest = max(x.numel() for _, x in _leaves(grads))
    st = co.dgc_init(grads)
    rounds = []
    for i in range(DGC_ROUNDS):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        send, st2 = co.dgc_compress(grads, st, sparsity=DGC_SPARSITY,
                                    momentum=DGC_MOMENTUM)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated() - base
        kept = total_k = 0
        for name, g in _leaves(grads):
            nk, k = _dgc_leaf_gate(
                torch, g, _np_get(st.u, name), _np_get(st.v, name),
                _np_get(send, name), _np_get(st2.u, name),
                _np_get(st2.v, name), f"round {i + 1} {name}")
            kept += nk
            total_k += k
        rounds.append({"ms": ms, "peak_above_inputs_gb": peak / 1e9,
                       "kept": kept, "k": total_k, "density": kept / n})
        del send, st
        st = st2
        gc.collect()
    # each call reads g, u and v and writes u, v and the send (fp32)
    nbytes = 6 * 4 * n
    b_ms, _ = bound(nbytes, 0)
    out = {"elements": n, "largest_leaf": biggest, "grads_s": grads_s,
           "rounds": rounds, "bound_ms": b_ms, "bytes_a_call": nbytes}
    log(f"  (b) DGC at GPT-1.3B (sparsity {DGC_SPARSITY}, momentum "
        f"{DGC_MOMENTUM}; {n} elements, largest leaf {biggest}; grads in "
        f"{grads_s:.1f} s): "
        + "; ".join(f"round {i + 1} {x['ms']:.2f} ms, peak +"
                    f"{x['peak_above_inputs_gb']:.2f} GB, density "
                    f"{x['density']:.6f} ({x['kept']} kept, k {x['k']})"
                    for i, x in enumerate(rounds))
        + f"; byte bound {b_ms:.2f} ms; every leaf of every round held to "
        f"the law")
    del st, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dgc_small_card_vs_cpu(torch, gpt, gpt_hybrid, co):
    """(b): DGC_ROUNDS rounds on a small fp32 model's gradients (drawn on
    the CPU, copied to the card): sends, u and v of the card equal the
    CPU's bit for bit."""
    cfg = _small_cfg(torch, gpt, {})
    params = gpt.init_master_params(cfg, 7, "cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 65)))
    _, g = gpt_hybrid.value_and_grad(
        lambda p, x: gpt.loss_fn(p, x, cfg), params, toks)
    gc_ = _tree_map(lambda t: t.cuda(), g)
    s_cpu, s_card = co.dgc_init(g), co.dgc_init(gc_)
    worst = 0
    for _ in range(DGC_ROUNDS):
        a, s_cpu = co.dgc_compress(g, s_cpu, DGC_SPARSITY, DGC_MOMENTUM)
        b, s_card = co.dgc_compress(gc_, s_card, DGC_SPARSITY, DGC_MOMENTUM)
        for x, y in ((a, b), (s_cpu.u, s_card.u), (s_cpu.v, s_card.v)):
            for name, t in _leaves(x):
                diff = int((t.view(torch.int32) !=
                            _np_get(y, name).cpu().view(torch.int32)).sum())
                worst = max(worst, diff)
    log(f"  (b) DGC on a small fp32 model, card vs CPU: {DGC_ROUNDS} rounds, "
        f"elements whose bits differ: {worst}")
    if worst:
        raise AssertionError(f"DGC on the card differs from the CPU in "
                             f"{worst} elements")
    return worst


def comm_small_cases(torch, gpt, steps):
    """(c)'s small cases for ``hybrid_check.run_cases`` on the four ranks
    and what each is held to: the functional pipeline on the small fp32
    model (PIPE_SMALL_RUNS, ``steps`` AdamW steps), DGC over dp4 and
    LocalSGD(k = LOCALSGD_K) over LOCALSGD_STEPS steps on small fp32
    trees.  Returns (cases,
    context for ``check_comm_small``)."""
    cfg = _small_cfg(torch, gpt, {"num_layers": PIPE_SMALL_LAYERS})
    master = gpt.init_master_params(cfg, 7, device="cpu")
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, HYBRID_BASE["vocab_size"], (8, 65))
               for _ in range(steps)]
    cases = [{"kind": "pipeline", "cfg": cfg, "mesh": mesh,
              "params": _np_tree(master), "batches": batches,
              "n_micro": m, "remat_stage": remat, "lr": TRAIN_LR,
              "opt": ("AdamW", {"learning_rate": TRAIN_LR}),
              "flags": HYBRID_FLAGS}
             for _, mesh, m, remat in PIPE_SMALL_RUNS]
    g = np.random.default_rng(4)
    dgc_grads = {"blocks": {"fc_w": g.standard_normal(
                     (HYBRID_RANKS, 2, 64, 256)).astype(np.float32)},
                 "wte": g.standard_normal(
                     (HYBRID_RANKS, 512, 64)).astype(np.float32)}
    params = {"w": g.standard_normal((HYBRID_RANKS, 64, 64)).astype(
                  np.float32),
              "b": g.standard_normal((HYBRID_RANKS, 64)).astype(np.float32)}
    deltas = [{k: (0.01 * g.standard_normal(v.shape)).astype(np.float32)
               for k, v in params.items()} for _ in range(LOCALSGD_STEPS)]
    cases += [{"kind": "dgc", "mesh": {"dp": HYBRID_RANKS},
               "grads": dgc_grads, "sparsity": DGC_SPARSITY,
               "momentum": DGC_MOMENTUM, "rounds": DGC_ROUNDS},
              {"kind": "localsgd", "mesh": {"dp": HYBRID_RANKS},
               "params": params, "deltas": deltas, "k_steps": LOCALSGD_K,
               "steps": LOCALSGD_STEPS}]
    return cases, {"cfg": cfg, "master": master, "batches": batches,
                   "dgc_grads": dgc_grads, "params": params,
                   "deltas": deltas}


def check_comm_small(torch, gpt_hybrid, optim, clip, hc, co, ctx, outs):
    """The small cases' gates, ``outs`` each rank's results of
    ``comm_small_cases``' cases in order: the pipeline's losses within
    TRAIN_LOSS_TOL of the one-card step's on the same masters and
    batches, each rank's #1-#7 launches exactly
    ``hc.expected_pipeline_launches``; DGC's sends within DGC_AXIS_RTOL of
    one card's mean of the ranks' sends, u and v bit-equal, one
    all-reduce a leaf a round; LocalSGD's params one card's mean on the
    sync steps and untouched between, all-reduces on the sync steps
    only (one a leaf).  Returns (stats, launches, tc launches)."""
    cfg = ctx["cfg"]
    with env_set(**HYBRID_FLAGS):
        ref_losses, _ = _one_card_run(torch, gpt_hybrid, optim, clip, cfg,
                                      ctx["master"], ctx["batches"], None)
    stats, total, tc_total, failed = {}, {}, {}, []
    for i, (name, mesh, m, remat) in enumerate(PIPE_SMALL_RUNS):
        ranks = [o[i] for o in outs]
        losses = ranks[0]["losses"]
        d = max(abs(a - b) for a, b in zip(losses, ref_losses))
        _add(total, _launch_gates(
            ranks, lambda c: hc.expected_pipeline_launches(
                cfg, mesh["pp"], m, c.get("pp", 0), remat), name))
        for x in ranks:
            for t in x["tc_launches"]:
                _add(tc_total, t)
        stats[name] = {"losses": losses, "max_loss_gap": d,
                       "launches_rank0": ranks[0]["launches"][-1],
                       "comm_rank0": ranks[0]["comm"][-1]}
        stats[name]["case_s_rank0"] = ranks[0]["case_s"]
        log(f"  (c) {name}: losses {[round(x, 5) for x in losses]}; "
            f"max|loss - one card| {d:.3g} (tol {TRAIN_LOSS_TOL}); rank 0 "
            f"launches a step {ranks[0]['launches'][-1]}; collectives a "
            f"step (rank 0) {json.dumps(ranks[0]['comm'][-1])}; rank 0 "
            f"step ms {[round(x, 1) for x in ranks[0]['step_ms']]}, the "
            f"case {ranks[0]['case_s']:.1f} s")
        if not (all(map(math.isfinite, losses)) and d <= TRAIN_LOSS_TOL):
            failed.append(f"{name} disagrees with the one-card step")
    j = len(PIPE_SMALL_RUNS)
    # DGC over dp4: one card runs each rank's rounds and means the sends
    dg = ctx["dgc_grads"]
    per_rank = []
    for r in range(HYBRID_RANKS):
        g = _tree_map(lambda a: torch.as_tensor(a[r]).cuda(), dg)
        st, rounds = co.dgc_init(g), []
        for _ in range(DGC_ROUNDS):
            s, st = co.dgc_compress(g, st, DGC_SPARSITY, DGC_MOMENTUM)
            rounds.append((s, st))
        per_rank.append(rounds)
    worst = 0.0
    n_leaves = 2
    for rank in range(HYBRID_RANKS):
        got = outs[rank][j]
        for i in range(DGC_ROUNDS):
            for name, _ in _leaves(dg):
                mean = sum(_np_get(per_rank[q][i][0], name)
                           for q in range(HYBRID_RANKS)) / HYBRID_RANKS
                want = mean.cpu().numpy()
                have = _np_get(got[i]["send"], name)
                err = float(np.abs(have - want).max() /
                            max(np.abs(want).max(), 1e-30))
                worst = max(worst, err)
                for what, idx in (("u", 0), ("v", 1)):
                    mine = _np_get(per_rank[rank][i][1][idx], name)
                    if not np.array_equal(_np_get(got[i][what], name),
                                          mine.cpu().numpy()):
                        failed.append(f"DGC dp4 rank {rank} round {i + 1} "
                                      f"{what} differs from one card's")
            calls = got[i]["comm"].get("all_reduce", {}).get("calls")
            if calls != n_leaves:
                failed.append(f"DGC dp4 rank {rank} round {i + 1}: {calls} "
                              f"all-reduces, not {n_leaves}")
    if worst > DGC_AXIS_RTOL:
        failed.append(f"DGC dp4 sends {worst:.3g} from one card's mean")
    stats["dgc_dp4"] = {"worst_send_rel": worst, "rounds": DGC_ROUNDS}
    log(f"  (c) DGC over dp4 ({DGC_ROUNDS} rounds): sends within {worst:.3g} "
        f"of one card's mean (tol {DGC_AXIS_RTOL}) relative to each leaf's "
        f"largest, u and v bit-equal, {n_leaves} all-reduces a round")
    # LocalSGD: one card replays every rank's steps and means on the syncs
    p = {k: v.astype(np.float64).copy() for k, v in ctx["params"].items()}
    worst_p, syncs, calls_all = 0.0, 0, []
    for step in range(1, LOCALSGD_STEPS + 1):
        for k in p:
            p[k] += ctx["deltas"][step - 1][k]
        if step % LOCALSGD_K == 0:
            for k in p:
                p[k][:] = p[k].mean(0)
            syncs += 1
        want_calls = len(p) if step % LOCALSGD_K == 0 else 0
        for rank in range(HYBRID_RANKS):
            got = outs[rank][j + 1][step - 1]
            for k in p:
                worst_p = max(worst_p, float(np.abs(
                    got["params"][k] - p[k][rank]).max()))
            calls_all.append(got["all_reduce"])
            if got["all_reduce"] != want_calls:
                failed.append(f"LocalSGD rank {rank} step {step}: "
                              f"{got['all_reduce']} all-reduces, not "
                              f"{want_calls}")
    stats["localsgd"] = {"k": LOCALSGD_K, "steps": LOCALSGD_STEPS,
                         "syncs": syncs, "worst_param": worst_p,
                         "all_reduces_rank0": sum(
                             calls_all[::HYBRID_RANKS])}
    log(f"  (c) LocalSGD k={LOCALSGD_K} over {LOCALSGD_STEPS} steps on "
        f"dp4: {syncs} syncs, {stats['localsgd']['all_reduces_rank0']} "
        f"all-reduces on rank 0 (one a leaf a sync, none between); params "
        f"within {worst_p:.3g} of one card's replay")
    if worst_p > 1e-5:
        failed.append(f"LocalSGD params {worst_p} from one card's")
    if failed:
        raise AssertionError("; ".join(failed))
    return stats, total, tc_total


def pipeline_1p3b_case(torch, gpt, tr, backend, toks):
    """(c)'s full-width case: GPT-1.3B's widths (PIPE_1P3B_LAYERS deep by
    backend) at dp2 x pp2, M = 2, ``remat_stage``, on the headline batch's
    first PIPE_1P3B_ROWS rows, its optimizer and flags, seed-0 masters
    drawn on each rank in turn."""
    r = tr.RUNGS[HYBRID_1P3B_RUNG]
    cfg = gpt.GPTConfig(**{**r.cfg, "num_layers": PIPE_1P3B_LAYERS[backend]})
    return {"kind": "pipeline", "cfg": cfg, "mesh": {"dp": 2, "pp": 2},
            "seed": 0, "batches": [toks[:PIPE_1P3B_ROWS]],
            "steps": PIPE_1P3B_STEPS, "n_micro": 2, "remat_stage": True,
            "lr": tr.LR, "opt": ("AdamW", {
                "learning_rate": tr.LR, "weight_decay": tr.WEIGHT_DECAY,
                "state_dtype": torch.bfloat16}),
            "flags": dict(r.flags), "stagger_init": True}


def check_pipeline_1p3b(torch, gpt, tr, hc, case, ranks, backend):
    """The full-width pipeline's gates: step 1's loss within
    HYBRID_1P3B_LOSS_TOL of the one-card loss of the same rows and depth
    (``one_card_loss``), the loss falling at step 2, each rank's #1-#7
    launches exact (the recompute included).  Returns (stats, launches,
    tc launches)."""
    cfg = case["cfg"]
    ref = one_card_loss(torch, gpt, tr, HYBRID_1P3B_RUNG, PIPE_1P3B_ROWS,
                        over={"num_layers": cfg.num_layers})
    name = f"pipeline GPT-1.3B widths dp2 x pp2 M=2 ({cfg.num_layers} layers)"
    total = _launch_gates(ranks, lambda c: hc.expected_pipeline_launches(
        cfg, 2, 2, c.get("pp", 0), True), name)
    tc = {}
    for x in ranks:
        for t in x["tc_launches"]:
            _add(tc, t)
    losses = ranks[0]["losses"]
    stats = {"layers": cfg.num_layers, "rows": PIPE_1P3B_ROWS,
             "losses": losses, "one_card_step1_loss": ref,
             "step_ms": [x["step_ms"] for x in ranks],
             "peak_gb": [x["peak_gb"] for x in ranks],
             "comm_rank0": ranks[0]["comm"][-1], "backend": backend,
             "case_s": [x["case_s"] for x in ranks]}
    log(f"  (c) {name}: losses {[round(x, 5) for x in losses]} (one card "
        f"{ref:.5f}, tol {HYBRID_1P3B_LOSS_TOL}); rank step ms "
        f"{[[round(m, 1) for m in x['step_ms']] for x in ranks]}; peak GB "
        f"{[x['peak_gb'] and round(x['peak_gb'], 2) for x in ranks]}; "
        f"launches a step "
        f"{[x['launches'][-1] for x in ranks]}; collectives a step (rank 0) "
        f"{json.dumps(ranks[0]['comm'][-1])}; the case "
        f"{[round(x['case_s'], 1) for x in ranks]} s a rank")
    if not (all(map(math.isfinite, losses))
            and abs(losses[0] - ref) <= HYBRID_1P3B_LOSS_TOL
            and losses[1] < losses[0]):
        raise AssertionError(f"{name}: losses {losses} against one card's "
                             f"{ref}")
    return stats, total, tc


def data_comm_phase(torch, gpt, gpt_hybrid, tr, ks, remat_policies,
                    in_memory):
    """The data and comm phase's one-process arms: (a) the reader-fed
    headline against the in-memory run ``in_memory`` (``train_path``'s
    stats of the headline rung); (b) DGC at full width and card vs CPU.
    (c)'s rank cases run in the hybrid phase's spawns.  The kernel counts
    are zeroed first.  Returns (stats, the launches of (a) and (b))."""
    from paddle_tpu_torch.distributed.fleet import comm_opt as co

    t0 = time.perf_counter()
    zero_counts(ks)
    a = reader_fed_headline(torch, gpt, tr, ks, remat_policies, in_memory)
    gc.collect()
    torch.cuda.empty_cache()
    b = dgc_full_width(torch, gpt, gpt_hybrid, tr, co)
    b["card_vs_cpu_bits_differing"] = dgc_small_card_vs_cpu(
        torch, gpt, gpt_hybrid, co)
    launches = launch_counts(ks)
    for k in tr.RUNGS[HYBRID_1P3B_RUNG].flags:
        os.environ.pop(k, None)
    stats = {"reader_fed": a, "dgc": b, "phase_s": time.perf_counter() - t0}
    log(f"[data and comm phase (a) + (b): {stats['phase_s']:.1f} s]")
    return stats, launches


# -- tensor- and expert-parallel serving (text/tp_serving.py) ----------------

TP_MOD = "paddle_tpu_torch.text.tp_serving"
SM_MOD = "paddle_tpu_torch.distributed.serving_mesh"
TP_RANKS = 4                     # one pool for the phase: mp2, mp4, ep2 x mp2
TP_TIMEOUT_S = 600.0             # every wait for a rank, every collective
TP_SMALL_NEW = 24
# the depth of (b) and (c) where the ranks share one card: each of a
# step's 50 gloo collectives is staged through the host and syncs its
# rank, so a 24-layer step takes 0.2-0.7 s there and the whole smoke
# must stay inside its time limit; four cards run all 24.
# (d) keeps 24 layers: its gate is the routed tie rule, and another depth
# is another model, whose near-tied routing choices the ranks' reduction
# order may flip
TP_ONE_CARD_LAYERS = 4
# (d)'s fp32 twin, held token by token and counter by counter
TP_MOE_EXACT_LAYERS = 4
# the slots the server places main's 8 requests in (the last free first)
TP_MOE_SLOTS = [7 - r for r in range(8)]
TP_ADMISSION_KINDS = ("prefill", "prefill_chunk", "paged_prefill",
                      "moe_prefill", "moe_prefill_chunk", "moe_paged_prefill")


def tp_rank_counts(ks, srv):
    """Each rank's kernel launches (by the kernels line's names):
    [{"launches": .., "tc_launches": .., "tick_launches": ..}] in rank
    order."""
    out = []
    for raw in srv._bind.counts():
        out.append({attr: {n: raw[f"{fn.__name__}.{attr}"]
                           for n, fn in ks.items() if hasattr(fn, attr)}
                    for attr in ("launches", "tc_launches",
                                 "tick_launches")})
    return out


def tp_arm(torch, engine, ks, srv, prompts, new, cfg, what, gate=True):
    """One tensor-parallel serve, warmed: the streams and, per rank, the
    launches (gated exact when ``gate``: every rank alike; contiguous —
    #1 on the tensor-core body once a layer an admission, #9 on the tick
    body once a layer a tick; paged — #10 on the tick body once a layer a
    tick and an admission chunk below R_TC, on the tensor-core body once a
    layer a chunk from R_TC on), the collectives a tick, reserved memory a
    rank and, on NCCL (graphs), one step replay a tick per rank with no
    capture after warmup.  Returns (streams, stats)."""
    from paddle_tpu_torch.ops.decode_attention import R_TC

    bind = srv._bind
    pool, members = bind.mesh.pool, bind.mesh.members
    # warmup captures a graphed server's steps; an eager one's would only
    # run them once more
    warm = (srv.warmup(prompt_lens=[len(p) for p in prompts])
            if bind.rank_graphs else {})
    g0 = pool.call(members, f"{TP_MOD}:rank_graphs", bind.bid)
    pool.call(members, f"{TP_MOD}:rank_reset_counts")
    pool.call(members, f"{TP_MOD}:rank_collectives", True)
    pool.call(members, f"{TP_MOD}:rank_step_ms", True)
    pool.call(members, f"{SM_MOD}:step_times", True)
    pool.steps, pool.step_s = 0, 0.0
    widths = []
    get = engine.ENGINE.get

    def counted_get(kind, spec):
        fn = get(kind, spec)
        if kind not in TP_ADMISSION_KINDS:
            return fn

        def counted(*feeds):
            widths.append(int(feeds[0].shape[1]))
            return fn(*feeds)
        return counted

    engine.ENGINE.get = counted_get
    try:
        served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
    finally:
        engine.ENGINE.get = get
    counts = tp_rank_counts(ks, srv)
    coll = pool.call(members, f"{TP_MOD}:rank_collectives", False)[0]
    dev_ms = pool.call(members, f"{TP_MOD}:rank_step_ms")[0]
    host = pool.call(members, f"{SM_MOD}:step_times")
    steps = {"round_trips": pool.steps,
             "round_trip_ms_mean": 1e3 * pool.step_s / max(1, pool.steps),
             "rank_step_ms_mean": [1e3 * h["step_s"] / max(1, h["steps"])
                                   for h in host],
             "rank0_device_ms_median": (statistics.median(dev_ms)
                                        if dev_ms else 0.0)}
    g1 = pool.call(members, f"{TP_MOD}:rank_graphs", bind.bid)
    mem = pool.call(members, f"{TP_MOD}:rank_memory")
    L, T = cfg.num_layers, len(ticks)
    if gate:
        if any(c != counts[0] for c in counts):
            raise AssertionError(f"{what}: the ranks launched other kernels: "
                                 f"{counts}")
        c = counts[0]
        la, tc, tick = c["launches"], c["tc_launches"], c["tick_launches"]
        if srv._paged:
            small = sum(w < R_TC for w in widths)
            want = {"flash_attention_fwd": 0, "decode_attention": 0,
                    "paged_decode_attention": L * (T + len(widths))}
            ok = (tick["paged_decode_attention"] == L * (T + small)
                  and tc["paged_decode_attention"] == L * (len(widths)
                                                           - small))
        else:
            want = {"flash_attention_fwd": L * len(widths),
                    "decode_attention": L * T, "paged_decode_attention": 0}
            ok = (tc["flash_attention_fwd"] == L * len(widths)
                  and tick["decode_attention"] == L * T)
        if any(la[n] != v for n, v in want.items()) or not ok:
            raise AssertionError(f"{what}: per-rank launches {c} against "
                                 f"{want} ({T} ticks, admission widths "
                                 f"{widths})")
    step = "serving.moe_step" if cfg.moe is not None else "serving.step"
    graphed = bind.rank_graphs
    if graphed:
        for r, (a, b) in enumerate(zip(g0, g1)):
            rep = b["replays"].get(step, 0) - a["replays"].get(step, 0)
            if b["captured"] != a["captured"] or rep != T:
                raise AssertionError(
                    f"{what}: rank {r} captured {b['captured'] - a['captured']}"
                    f" graphs in the serve and replayed {step} {rep} times "
                    f"for {T} ticks")
    n_tok = sum(len(x) for x in served)
    st = {"transport": bind.mesh.transport, "graphs": graphed,
          "ranks": len(members), "ticks": T, "tokens": n_tok,
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "tick_ms_mean": 1e3 * statistics.mean(ticks),
          "tick_ms_median": 1e3 * statistics.median(ticks),
          "admission_ms": 1e3 * t_admit, "admission_widths": widths,
          "warmup_s": sum(warm.values()),
          "reserved_gb_per_rank": [m["reserved"] / 1e9 for m in mem],
          "collectives": coll,
          "collective_calls_per_tick": {k: v["calls"] / T
                                        for k, v in coll.items()},
          "collective_bytes_per_tick": {k: v["bytes"] / T
                                        for k, v in coll.items()},
          "rank_launches": counts[0]["launches"],
          "rank_tc_launches": counts[0]["tc_launches"],
          "rank_tick_launches": counts[0]["tick_launches"],
          "captured_graphs_per_rank": [g["captured"] for g in g1],
          "steps": steps}
    log(f"  {what}: tokens/s {st['tokens_per_s']:.1f}, tick ms mean "
        f"{st['tick_ms_mean']:.3f} median {st['tick_ms_median']:.3f}, "
        f"admission {st['admission_ms']:.1f} ms, reserved GB a rank "
        f"{[round(x, 3) for x in st['reserved_gb_per_rank']]}, collectives "
        f"a tick {json.dumps(st['collective_calls_per_tick'])} bytes a tick "
        f"{json.dumps(st['collective_bytes_per_tick'])}, launches a rank "
        f"{ {k: v for k, v in st['rank_launches'].items() if v} } (tick "
        f"body { {k: v for k, v in st['rank_tick_launches'].items() if v} }, "
        f"tensor-core { {k: v for k, v in st['rank_tc_launches'].items() if v} }"
        f"), {bind.mesh.transport}, graphs {graphed}; a step call "
        f"{steps['round_trip_ms_mean']:.3f} ms round trip, on the ranks "
        f"{[round(x, 3) for x in steps['rank_step_ms_mean']]} ms from frame "
        f"to done, rank 0's card {steps['rank0_device_ms_median']:.3f} ms "
        f"(median)")
    return served, st


def one_card_arm(torch, engine, srv, prompts, new):
    """The single-card server's graphed serve, warmed: (streams, stats)."""
    warm = srv.warmup(prompt_lens=[len(p) for p in prompts])
    served, t_admit, ticks, wall = serve(torch, srv, prompts, new)
    n_tok = sum(len(x) for x in served)
    st = {"tokens_per_s": n_tok / wall, "ticks": len(ticks),
          "tick_ms_mean": 1e3 * statistics.mean(ticks),
          "tick_ms_median": 1e3 * statistics.median(ticks),
          "admission_ms": 1e3 * t_admit, "warmup_s": sum(warm.values()),
          "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    log(f"  one card: tokens/s {st['tokens_per_s']:.1f}, tick ms mean "
        f"{st['tick_ms_mean']:.3f} median {st['tick_ms_median']:.3f}, "
        f"admission {st['admission_ms']:.1f} ms")
    return served, st


def _add_rank(total, counts, ranks):
    for n, v in counts.items():
        total[n] = total.get(n, 0) + v * ranks


def tp_small(torch, gpt, serving, lora, A, m2):
    """(a) and (e): the small fp32 models (fp32 and int8 KV, contiguous
    and paged) at mp2 against the single-card server on the card —
    exactly the same greedy streams; eager, and on NCCL graphed too.
    Then (e): a speculating server (draft == target, linear K = SPEC_K and
    a tree of SPEC_K nodes; n-gram self-drafting) and an adapter pool of
    two adapters at mp2, each against its single-card twin."""
    out = {}
    graphs = (False, True) if m2.transport == "nccl" else (False,)
    models = list(_small_models(torch, gpt))
    if m2.transport != "nccl":
        # one card: MHA with an fp32 cache and GQA with an int8 one
        models = [models[0], models[3]]
    for name, cfg, kv in models:
        os.environ["PADDLE_TPU_KV_DTYPE"] = kv
        params = gpt.init_params(cfg, seed=11, device="cuda")
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (7, 60, 100)]
        for layout in ("contiguous", "paged"):
            one = _small_server(serving, cfg, params, "cuda", layout)
            ref = serve(torch, one, prompts, TP_SMALL_NEW)[0]
            one.close()
            for g in graphs:
                lay = (dict(layout="paged", block_size=16, num_blocks=48)
                       if layout == "paged" else {})
                srv = serving.DecodeServer(params, cfg, max_batch=4,
                                           max_len=160, mesh=m2, _graphs=g,
                                           **lay)
                if layout == "paged":
                    srv._pool._free = np.random.default_rng(0).permutation(
                        srv._pool.N).tolist()
                got = serve(torch, srv, prompts, TP_SMALL_NEW)[0]
                srv.close()
                key = f"{name}{'-int8' if kv else ''} {layout} " \
                      f"{'graphed' if g else 'eager'}"
                out[key] = got == ref
                if got != ref:
                    raise AssertionError(f"tp small {key}: {got} vs {ref}")
        del params
    os.environ.pop("PADDLE_TPU_KV_DTYPE", None)
    log(f"  (a) small fp32 models at mp2, streams equal to one card's: "
        f"{json.dumps(out)}")
    # (e) speculation and an adapter pool on the mesh
    name, cfg, _ = list(_small_models(torch, gpt))[1]
    params = gpt.init_params(cfg, seed=11, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (7, 60, 100)]
    spec = {}
    arms = [("linear draft==target", dict(spec_k=SPEC_K, draft_cfg=cfg,
                                           draft_params=params)),
            ("linear n-gram", dict(spec_k=SPEC_K)),
            ("tree draft==target", dict(spec_tree=SPEC_K, draft_cfg=cfg,
                                         draft_params=params))]
    # one card: the contiguous layout (the small models' paged arms above
    # and the CPU tests hold the paged twins)
    layouts = (("contiguous", "paged") if m2.transport == "nccl"
               else ("contiguous",))
    for arm, kw in arms:
        for layout in layouts:
            ref = serve(torch, _small_server(serving, cfg, params, "cuda",
                                             layout, **kw),
                        prompts, TP_SMALL_NEW)[0]
            lay = (dict(layout="paged", block_size=16, num_blocks=48)
                   if layout == "paged" else {})
            srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                                       mesh=m2, **lay, **kw)
            got = serve(torch, srv, prompts, TP_SMALL_NEW)[0]
            srv.close()
            spec[f"{arm} {layout}"] = got == ref
            if got != ref:
                raise AssertionError(f"tp spec {arm} {layout}: {got} vs "
                                     f"{ref}")
    engine_purge(cfg)
    ads = make_adapters(torch, lora, params, cfg, 2, 8, SMALL_B_STD)
    jobs = [(p, a) for p in prompts for a in (None, "a0", "a1")]

    def pool_serve(**kw):
        pool = A.AdapterPool(params, cfg, rank=8, max_adapters=2)
        pool.register("a0", ads[0])
        srv = serving.DecodeServer(params, cfg, max_batch=4, max_len=160,
                                   adapter_pool=pool, **kw)
        pool.register("a1", ads[1])       # after the build: the ranks too
        rids = [srv.submit(p, max_new_tokens=TP_SMALL_NEW, adapter=a)
                for p, a in jobs]
        while srv.pending():
            srv.tick()
        got = [srv.result(r) for r in rids]
        srv.close()
        return got

    ref = pool_serve(device="cuda")
    got = pool_serve(mesh=m2)
    spec["adapter pool (2 adapters, one registered after the build)"] = \
        got == ref
    if got != ref:
        raise AssertionError(f"tp adapter pool: {got} vs {ref}")
    if len({tuple(x) for x in ref}) < 2:
        raise AssertionError("the adapters changed no stream")
    del params
    log(f"  (e) speculation and an adapter pool at mp2 (small gqa-rope "
        f"fp32), streams equal to one card's: {json.dumps(spec)}")
    out.update(spec)
    return out


def engine_purge(cfg):
    from paddle_tpu_torch.text import engine

    engine.ENGINE.purge(cfg)


def tp_1p3b(torch, gpt, serving, engine, ks, wl, meshes, total, tc_total,
            tick_total, layers=None):
    """(b) GPT-1.3B (bf16, seed 0; at ``layers`` layers when given) at mp2
    and mp4, main and paged: main's or paged's 8 requests x 64 greedy
    tokens against the single-card graphed server by the tie rule.  The
    weights are cut over each mesh once (``tp_serving.shard_params``) and
    serve both paths."""
    from paddle_tpu_torch.text import tp_serving

    cfg = tp_cfg(gpt.gpt_1p3b(), layers)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    prompts = {"main": wl.main_prompts(cfg.vocab_size, 0),
               "paged": wl.paged_prompts(cfg.vocab_size, 0)}
    out, ref = {}, {}
    for path in ("main", "paged"):
        one = wl.make_server(path, params, cfg, "cuda")
        ref[path], st1 = one_card_arm(torch, engine, one, prompts[path],
                                      wl.NEW)
        one.close()
        del one
        out[path] = {"one_card": st1}
    gc.collect()
    torch.cuda.empty_cache()
    for mname, mesh in meshes:
        t0 = time.perf_counter()
        sharded = tp_serving.shard_params(params, cfg, mesh)
        cut_s = time.perf_counter() - t0
        for path in ("main", "paged"):
            srv = wl.make_server(path, sharded, cfg, mesh=mesh)
            got, st = tp_arm(torch, engine, ks, srv, prompts[path], wl.NEW,
                             cfg, f"(b) {path} {mname}")
            srv.close()
            st["cut_and_upload_s"] = cut_s
            st["streams_equal"] = hold_streams(
                torch, gpt, params, cfg, prompts[path], got, ref[path],
                f"(b) {path} {mname}")
            st["tick_vs_one_card"] = st["tick_ms_median"] / out[path][
                "one_card"]["tick_ms_median"]
            n = st["ranks"]
            _add_rank(total, st["rank_launches"], n)
            _add_rank(tc_total, st["rank_tc_launches"], n)
            _add_rank(tick_total, st["rank_tick_launches"], n)
            out[path][mname] = st
        tp_serving.ShardedParams.of(sharded).release()
        del sharded
        log(f"  (b) {mname}: the weights cut and sent to the ranks in "
            f"{cut_s:.1f} s")
    del params
    engine_purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return out


TP_W4_STEPS = 16


def tp_int4(torch, gpt, G, woq, engine, wl, m2, total, tc_total,
            layers=None):
    """(c) ``build_sharded_decode`` on GPT-1.3B's int4 weights (group 64)
    at mp2 under the W4 kernel: TP_W4_STEPS steps of 8 slots against the
    single-card ``decode_step`` on the same weights — the logits' largest
    gap, every greedy choice equal or within TIE_TOL of the best — and
    per rank 6 launches of #8 a layer a step (qkv's three slices, proj,
    fc and out; 144 at 24 layers), all on the tensor-core body."""
    os.environ.update(wl.W4_FLAGS)
    try:
        cfg = tp_cfg(gpt.gpt_1p3b(), layers)
        params = woq.quantize_gpt_int4(
            gpt.init_params(cfg, seed=0, device="cuda"),
            group_size=wl.W4_GROUP)
        prompts = wl.main_prompts(cfg.vocab_size, 0)
        B = len(prompts)
        sp, make_cache, decode = G.build_sharded_decode(params, cfg, m2)
        cache = make_cache(B, 64)
        ref_cache = G.init_cache(cfg, B, 64, "cuda")
        pool = m2.pool
        pool.call(m2.members, f"{TP_MOD}:rank_reset_counts")
        gap = worst_tie = 0.0
        agree = 0
        t_one, t_tp = [], []
        for pos in range(TP_W4_STEPS):
            tok = torch.tensor([p[pos] for p in prompts])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, ref_cache = G.decode_step(params, ref_cache, tok.to("cuda"),
                                            pos, cfg)
            want = want.cpu()
            t_one.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got, cache = decode(sp, cache, tok, pos)
            t_tp.append(time.perf_counter() - t0)
            gap = max(gap, (got - want).abs().max().item())
            for b in range(B):
                a = int(got[b].argmax())
                tie = (want[b].max() - want[b, a]).item()
                worst_tie = max(worst_tie, tie)
                agree += int(a == int(want[b].argmax()))
        raw = cache.binding.counts()
        w4 = [r["w4_matmul.launches"] for r in raw]
        w4tc = [r["w4_matmul.tc_launches"] for r in raw]
        want_n = 6 * cfg.num_layers * TP_W4_STEPS
        if w4 != [want_n] * 2 or w4tc != [want_n] * 2:
            raise AssertionError(f"(c) #8 launches a rank {w4} (tensor-core "
                                 f"{w4tc}) against {want_n}")
        if worst_tie > TIE_TOL:
            raise AssertionError(f"(c) a sharded greedy choice sits "
                                 f"{worst_tie} under the best logit")
        st = {"steps": TP_W4_STEPS, "slots": B, "max_abs_logit_gap": gap,
              "argmax_equal": agree, "of": B * TP_W4_STEPS,
              "worst_choice_gap": worst_tie,
              "w4_launches_per_rank": w4, "w4_tc_launches_per_rank": w4tc,
              "step_ms_one_card_median": 1e3 * statistics.median(t_one[2:]),
              "step_ms_mp2_median": 1e3 * statistics.median(t_tp[2:]),
              "weights": "int4 group 64, int8 embedding"}
        _add_rank(total, {"w4_matmul": w4[0]}, 2)
        _add_rank(tc_total, {"w4_matmul": w4tc[0]}, 2)
        log(f"  (c) build_sharded_decode, int4 at mp2: {json.dumps(st)}")
        del cache, sp, params, ref_cache
        engine_purge(cfg)
    finally:
        for k in wl.W4_FLAGS:
            os.environ.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()
    return st


def moe_forced_gaps(rows, got):
    """gaps[r][i]: the best logit less the logit of ``got[r][i]`` in its
    row of ``rows`` (teacher-forced on ``got``)."""
    return [[(row.max() - row[t]).item() for row, t in zip(rows[r], g)]
            for r, g in enumerate(got)]


def tp_moe(torch, gpt, G, serving, moe, moe_serving, engine, ks, wl, m22,
           total, tc_total, tick_total, layers=None):
    """(d) The 8-expert GPT-1.3B-width MoE model (bf16, cf MOE_CF) at
    ep2 x mp2 — each rank 4 experts and half of each one's FFN columns,
    cut on the host — serving main's 8 requests x 64 tokens against the
    single-card eager server by the routed tie rule (``moe_hold``: the
    first step where a stream leaves one card's is a tie).  Past that
    step, and wherever the ranks' bf16 reduction order flips a near-tied
    routing choice, the contexts part; so the TP server's own streams are
    also teacher-forced through one card's joint step (``moe_forced_rows``
    on ``got``) and read against it — the share of tokens within TIE_TOL
    of their row's best, the drop and load counters against the forced
    run's.  The exact hold of every sharded tick is
    :func:`tp_moe_exact`'s, in fp32."""
    cfg = tp_cfg(moe_config(gpt, moe), layers)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = wl.main_prompts(cfg.vocab_size, 0)
    one = wl.make_server("main", params, cfg, "cuda", _graphs=False)
    ref, _, oticks, owall = serve(torch, one, prompts, wl.NEW)
    ref_drops = one._moe_snapshot()
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = wl.make_server("main", params, cfg, mesh=m22, ep_axis="ep")
    cut_s = time.perf_counter() - t0
    m = srv.params["blocks"]["moe"]
    shapes = {n: m[n].shard_shape() for n in ("w_in", "w_out", "router_w")}
    got, st = tp_arm(torch, engine, ks, srv, prompts, wl.NEW, cfg,
                     "(d) MoE main ep2 x mp2")
    drops = srv._moe_snapshot()
    srv.close()
    rows, forced = moe_forced_rows(torch, G, serving, moe_serving, params,
                                   cfg, prompts, got, TP_MOE_SLOTS)
    st["streams_equal"], st["divergence"] = moe_hold(
        rows, got, ref, "(d) MoE ep2 x mp2 vs one card")
    gaps = [g for row in moe_forced_gaps(rows, got) for g in row]
    del rows
    st["forced"] = {
        "within_tie": sum(g <= TIE_TOL for g in gaps) / len(gaps),
        "worst_gap": max(gaps), "dropped": forced[0], "load": forced[1],
        "dropped_less_forced": drops[0] - forced[0],
        "load_l1_from_forced": sum(abs(a - b)
                                   for a, b in zip(drops[1], forced[1]))}
    st.update(init_s=init_s, cut_and_upload_s=cut_s, rank_shapes=shapes,
              moe_dropped_tokens=drops[0], moe_expert_load=drops[1],
              one_card={"dropped": ref_drops[0], "load": ref_drops[1],
                        "eager_tick_ms_median":
                        1e3 * statistics.median(oticks),
                        "eager_tokens_per_s":
                        sum(len(x) for x in ref) / owall})
    log(f"  (d) rank blocks {shapes}; drops {drops[0]} (one card "
        f"{ref_drops[0]}), load {drops[1]} (one card {ref_drops[1]}); "
        f"cut and upload {cut_s:.1f} s")
    log(f"  (d) its own streams teacher-forced through one card's joint "
        f"step (a reading): {json.dumps(st['forced'])}")
    _add_rank(total, st["rank_launches"], 4)
    _add_rank(tc_total, st["rank_tc_launches"], 4)
    _add_rank(tick_total, st["rank_tick_launches"], 4)
    del params
    engine_purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return st


def tp_moe_exact(torch, gpt, G, serving, moe, moe_serving, wl, m22):
    """(d) held at every tick: the same MoE widths in fp32 at
    TP_MOE_EXACT_LAYERS layers, at ep2 x mp2, serving main's 8 requests x
    64 tokens.  The TP server's own streams are teacher-forced through one
    card's joint routed step (``moe_forced_rows`` on ``got``): every token
    of every stream must be within PATH_TOL of its row's best logit, and
    the server's drop and load counters must equal the forced run's — so
    each of the 63 sharded ticks (the E/ep experts, the F/mp columns, the
    (ep, mp) reduction, the replicated counters) is held to one card.  In
    fp32 the ranks' reduction order moves the router's logits by fp32
    rounding alone, so no top-k choice flips, as bf16's may in (d).  The
    streams' equality with the single-card server is read too."""
    cfg = tp_cfg(moe_config(gpt, moe, dtype=torch.float32),
                 TP_MOE_EXACT_LAYERS)
    params = gpt.init_params(cfg, seed=0, device="cuda")
    prompts = wl.main_prompts(cfg.vocab_size, 0)
    one = wl.make_server("main", params, cfg, "cuda", _graphs=False)
    ref = serve(torch, one, prompts, wl.NEW)[0]
    ref_drops = one._moe_snapshot()
    one.close()
    del one
    srv = wl.make_server("main", params, cfg, mesh=m22, ep_axis="ep")
    got, _, ticks, wall = serve(torch, srv, prompts, wl.NEW)
    drops = srv._moe_snapshot()
    srv.close()
    rows, forced = moe_forced_rows(torch, G, serving, moe_serving, params,
                                   cfg, prompts, got, TP_MOE_SLOTS)
    gaps = moe_forced_gaps(rows, got)
    del rows
    worst = max(max(g) for g in gaps)
    st = {"layers": TP_MOE_EXACT_LAYERS, "ticks": len(ticks),
          "tokens": sum(len(g) for g in got), "wall_s": wall,
          "forced_worst_gap": worst,
          "streams_equal_one_card": sum(g == f for g, f in zip(got, ref)),
          "dropped": drops[0], "load": drops[1],
          "forced": {"dropped": forced[0], "load": forced[1]},
          "one_card": {"dropped": ref_drops[0], "load": ref_drops[1]}}
    log(f"  (d) exact, fp32 at {TP_MOE_EXACT_LAYERS} layers: "
        f"{json.dumps(st)}")
    if not worst <= PATH_TOL:
        bad = [(r, i) for r, g in enumerate(gaps)
               for i, x in enumerate(g) if x > PATH_TOL]
        raise AssertionError(f"(d) exact: tokens (request, index) {bad[:8]}"
                             f" not their forced row's best (worst gap "
                             f"{worst}, tol {PATH_TOL})")
    if drops != forced:
        raise AssertionError(f"(d) exact: drops / load {drops} vs the "
                             f"forced run's {forced}")
    if st["streams_equal_one_card"] == len(prompts) and drops != ref_drops:
        raise AssertionError(f"(d) exact: equal streams but drops / load "
                             f"{drops} vs one card's {ref_drops}")
    del params
    engine_purge(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return st


def tp_cfg(cfg, layers):
    """``cfg`` at ``layers`` layers (None: as it is) — the width whole."""
    import dataclasses

    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def tp_phase(torch, gpt, G, serving, engine, ks, wl, woq):
    """The tensor- and expert-parallel serving phase: one pool of TP_RANKS
    rank processes (four cards: NCCL, a card a rank, graphs; one card:
    the ranks share it over gloo, eagerly) and meshes over it — (a) + (e)
    the small fp32 models, (b) GPT-1.3B at mp2 and mp4, (c) int4
    ``build_sharded_decode`` at mp2, (d) the MoE model at ep2 x mp2 and
    its fp32 twin.  Returns (stats, launches, tensor-core launches, tick-body launches —
    summed over the ranks of (b), (c), (d))."""
    from paddle_tpu_torch.distributed import serving_mesh as sm
    from paddle_tpu_torch.text import adapters as A
    from paddle_tpu_torch.text import lora, moe, moe_serving

    t0 = time.perf_counter()
    pool = sm.RankPool(TP_RANKS, timeout_s=TP_TIMEOUT_S)
    try:
        start_s = time.perf_counter() - t0
        m2, m4 = pool.mesh({"mp": 2}), pool.mesh({"mp": 4})
        m22 = pool.mesh({"ep": 2, "mp": 2})
        n_cards = torch.cuda.device_count()
        peer = [torch.cuda.can_device_access_peer(0, j)
                for j in range(1, n_cards)]
        log(f"  {TP_RANKS} ranks up in {start_s:.1f} s: {pool.transport} "
            f"over {[str(d) for d in pool.devices]}; card 0 reaches cards "
            f"1-{n_cards - 1} peer to peer: {peer}")
        total, tc_total, tick_total = {}, {}, {}
        stats = {"ranks": TP_RANKS, "transport": pool.transport,
                 "devices": [str(d) for d in pool.devices],
                 "peer_to_peer": peer, "start_s": start_s}
        t1 = time.perf_counter()
        stats["small"] = tp_small(torch, gpt, serving, lora, A, m2)
        stats["small_s"] = time.perf_counter() - t1
        layers = None if pool.transport == "nccl" else TP_ONE_CARD_LAYERS
        stats["layers"] = layers or 24
        log(f"  (b) and (c) at {stats['layers']} layers, (d) at 24, its "
            f"fp32 twin at {TP_MOE_EXACT_LAYERS}")
        stats["gpt_1p3b"] = tp_1p3b(torch, gpt, serving, engine, ks, wl,
                                    (("mp2", m2), ("mp4", m4)), total,
                                    tc_total, tick_total, layers)
        stats["int4"] = tp_int4(torch, gpt, G, woq, engine, wl, m2, total,
                                tc_total, layers)
        stats["moe"] = tp_moe(torch, gpt, G, serving, moe, moe_serving,
                              engine, ks, wl, m22, total, tc_total,
                              tick_total)
        stats["moe_exact"] = tp_moe_exact(torch, gpt, G, serving, moe,
                                          moe_serving, wl, m22)
    finally:
        pool.close()
    stats["phase_s"] = time.perf_counter() - t0
    log(f"  the phase's launches, all ranks: {json.dumps(total)}; on "
        f"tensor cores {json.dumps(tc_total)}; on the tick body "
        f"{json.dumps(tick_total)}")
    log(f"[tensor-parallel serving phase: {stats['phase_s']:.1f} s]")
    return stats, total, tc_total, tick_total


# ---------------------------------------------------------------------------
# the parameter-server services: host tables, DLRM on the card,
# device tables
# ---------------------------------------------------------------------------

PS_STEPS = 200               # train_step steps, then as many streamed
PS_TABLE_TOL = 1e-6          # device table, card vs CPU: relative
PS_REPLAY_TOL = 1e-5         # fp32 rows vs the float64 adagrad replay
PS_SHARD_TOL = 1e-6          # row-sharded vs one card: rows, absolute
# accumulators, relative: a hot row of a 3-row slot merges ~700 duplicate
# grads a push, summed in index_add_'s atomic order on each side
PS_SHARD_ACC_RTOL = 1e-5
PS_HETER_ROWS_TOL = 2e-3     # a small HeterTrainer's rows, card vs CPU
PS_SAMPLE = 1024
PS_SHARD_SCALE = 16          # (d): 1/16 of the rows


class _TimedClient:
    """Forwards to a ``PSClient``, timing every pull and shard push (wall
    ms, in the thread that made it), and keeping the largest |grad| each
    row of ``watch`` (sorted global ids) was pushed."""

    def __init__(self, client, watch):
        self._c = client
        self.pull_ms, self.push_ms = [], []
        self.watch = watch
        self.max_grad = np.zeros(len(watch))

    def __getattr__(self, k):
        return getattr(self._c, k)

    def pull_sparse(self, tid, ids):
        t0 = time.perf_counter()
        out = self._c.pull_sparse(tid, ids)
        self.pull_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def push_sparse_shard(self, s, tid, ids, grads, lr=0.05):
        t0 = time.perf_counter()
        self._c.push_sparse_shard(s, tid, ids, grads, lr=lr)
        self.push_ms.append((time.perf_counter() - t0) * 1e3)
        glob = np.asarray(ids) * self._c.S + s
        j = np.searchsorted(self.watch, glob).clip(max=len(self.watch) - 1)
        hit = self.watch[j] == glob
        np.maximum.at(self.max_grad, j[hit],
                      np.abs(np.asarray(grads)[hit]).max(axis=1))


def _median(xs):
    return statistics.median(xs) if xs else None


def ps_small(torch, ps_check, workdir):
    """(a): the 4096 x 16 device table and the V = 64 trainer, card
    against CPU."""
    rows_err, acc_err = ps_check.small_table_vs_cpu("cuda",
                                                    rtol=PS_TABLE_TOL)
    log(f"  (a) device table 4096 x 16, 20 adagrad pushes, card vs CPU: "
        f"largest |card - CPU| / ({PS_TABLE_TOL} |CPU| + 1e-7): rows "
        f"{rows_err:.3g}, accumulator {acc_err:.3g} (gate 1)")
    assert rows_err <= 1 and acc_err <= 1, (rows_err, acc_err)
    out = ps_check.small_heter_vs_cpu("cuda", workdir)
    cpu, card = out["cpu"], out["card"]
    loss_gap = float(np.abs(np.array(card["losses"])
                            - np.array(cpu["losses"])).max())
    push_gap = 0.0
    assert len(card["first_pushes"]) == len(cpu["first_pushes"])
    for (s1, i1, g1), (s2, i2, g2) in zip(card["first_pushes"],
                                          cpu["first_pushes"]):
        assert s1 == s2 and np.array_equal(i1, i2)
        push_gap = max(push_gap, float(np.abs(g1 - g2).max()))
    rows = np.abs(card["rows"] - cpu["rows"])
    far = float((rows > 1e-5).mean())      # a reading
    log(f"  (a) HeterTrainer V=64, 20 steps, card vs CPU (each on its own "
        f"two-server cluster): losses within {loss_gap:.3g}, step-1 pushed "
        f"row grads within {push_gap:.3g}; rows: {far:.4f} of elements past "
        f"1e-5, max {float(rows.max()):.3g}")
    assert loss_gap <= TRAIN_LOSS_TOL, loss_gap
    assert push_gap <= 1e-7, push_gap
    # the servers' adagrad (and Adam on the dense params) turn last-bit
    # differences of nearly cancelled grads into larger steps (ROADMAP C)
    assert rows.max() <= PS_HETER_ROWS_TOL, (far, rows.max())
    return {"table_rows_excess": rows_err, "table_accum_excess": acc_err,
            "loss_gap": loss_gap, "step1_push_gap": push_gap,
            "rows_far_share": far, "rows_max": float(rows.max())}


def ps_criteo_heter(torch, cd, ps_service, heter, optim, wl, workdir):
    """(b): the Criteo Kaggle table on two host servers, DLRM on the
    card through a ``HeterTrainer``."""
    t0 = time.perf_counter()
    procs, eps = ps_service.start_servers(2, workdir)
    client = ps_service.PSClient(eps, timeout=600)
    try:
        client.create_table(0, cd.TOTAL_ROWS, cd.DIM, seed=0,
                            init_range=0.01)
        up_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        batches = [cd.batch(rng) for _ in range(2 * PS_STEPS + 12)]
        touched = np.unique(np.concatenate([b[0].ravel()
                                            for b in batches]))
        sample = np.sort(rng.choice(touched, PS_SAMPLE, replace=False))
        cand = np.unique(rng.integers(0, cd.TOTAL_ROWS, 4 * PS_SAMPLE))
        untouched = np.setdiff1d(cand, touched)[:PS_SAMPLE]
        before_t = client.pull_sparse(0, sample)
        before_u = client.pull_sparse(0, untouched)
        timed = _TimedClient(client, sample)
        trainer = heter.HeterTrainer(
            timed, 0, cd.DIM, cd.init_params(0, "cuda"), cd.dense_apply,
            optim.SGD(learning_rate=cd.LR), sparse_lr=cd.LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ways = [], {}
        for way in ("train_step", "train_stream"):
            timed.pull_ms.clear()
            timed.push_ms.clear()
            part = batches[:PS_STEPS] if way == "train_step" else \
                batches[PS_STEPS:2 * PS_STEPS]
            marks = [time.perf_counter()]
            if way == "train_step":
                for ids, b in part:
                    losses.append(trainer.train_step(ids, b))
                    marks.append(time.perf_counter())
            else:
                for loss in trainer.train_stream(iter(part)):
                    losses.append(loss)
                    marks.append(time.perf_counter())
            step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
            ways[way] = {"step_ms_median": _median(step_ms[10:]),
                         "step_ms_mean": statistics.mean(step_ms[10:]),
                         "pull_ms_median": _median(timed.pull_ms),
                         "push_ms_median": _median(timed.push_ms),
                         "wall_s": marks[-1] - marks[0]}
        # a profiled window of train_step: device ms a step, busy share
        from torch.profiler import ProfilerActivity, profile

        extra = batches[2 * PS_STEPS:]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for ids, b in extra:
                trainer.train_step(ids, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        prof_sum = wl.summarize(torch, prof, wall, len(extra))
        peak = torch.cuda.max_memory_allocated() / 2**30
        after_t = client.pull_sparse(0, sample)
        after_u = client.pull_sparse(0, untouched)
    finally:
        client.shutdown_servers()
        client.close()
        for p in procs:
            p.wait(timeout=60)
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    # a row moves iff some push gave it a non-zero grad (a row seen only
    # behind dead ReLUs is pushed exact zeros, and adagrad leaves it)
    changed = (after_t != before_t).any(axis=1)
    pushed = timed.max_grad > 0
    moved = float(changed[pushed].mean())
    uniq = statistics.mean(len(np.unique(b[0])) for b in batches)
    out = {"rows": cd.TOTAL_ROWS, "dim": cd.DIM, "servers": 2,
           "up_s": up_s, "ways": ways, "loss_first20": first,
           "loss_last20": last, "touched_moved_share": moved,
           "touched_zero_grad_share": float(1 - pushed.mean()),
           "untouched_bit_equal": bool(np.array_equal(after_u, before_u)),
           "unique_rows_a_step": uniq, "peak_gb": peak,
           "profiled": {k: prof_sum[k] for k in ("wall_ms", "device_ms",
                                                 "device_busy_share",
                                                 "launches")},
           "flops_a_step": cd.step_flops()}
    log(f"  (b) Criteo Kaggle table {cd.TOTAL_ROWS} x {cd.DIM} on 2 host "
        f"servers (up and filled in {up_s:.1f} s); DLRM on the card, batch "
        f"{cd.BATCH}, {uniq:.1f} unique rows a step")
    for way, w in ways.items():
        log(f"  (b) {way}: step ms median {w['step_ms_median']:.3f} (mean "
            f"{w['step_ms_mean']:.3f}), pull ms median "
            f"{w['pull_ms_median']:.3f}, push ms median "
            f"{w['push_ms_median']:.3f} a shard, {PS_STEPS} steps in "
            f"{w['wall_s']:.2f} s")
    log(f"  (b) profiled train_step: wall {prof_sum['wall_ms']:.3f} ms, "
        f"device {prof_sum['device_ms']} ms, busy "
        f"{prof_sum['device_busy_share']}; peak {peak:.3f} GB; loss "
        f"first 20 {first:.5f} -> last 20 {last:.5f}; of {PS_SAMPLE} "
        f"sampled touched rows {int(pushed.sum())} were pushed a non-zero "
        f"grad, of which {moved:.4f} moved, and every one pushed only "
        f"zeros kept its bits: {not changed[~pushed].any()}; untouched "
        f"bit-equal {out['untouched_bit_equal']}")
    assert last < first, (first, last)
    assert moved == 1.0 and not changed[~pushed].any(), moved
    assert out["untouched_bit_equal"]
    return out


def _adagrad_replay(rows0, sample, pushes, lr, dim):
    """float64 host replay of merged adagrad pushes on the (sorted)
    ``sample`` rows."""
    n = len(sample)
    rows = rows0.astype(np.float64).copy()
    acc = np.zeros(n)
    for ids, g in pushes:
        flat = ids.reshape(-1)
        idx = np.searchsorted(sample, flat).clip(max=n - 1)
        hit = sample[idx] == flat
        m = np.zeros((n, dim))
        np.add.at(m, idx[hit], g.reshape(-1, dim)[hit].astype(np.float64))
        t = np.zeros(n, bool)
        t[idx[hit]] = True
        acc[t] += (m[t] ** 2).sum(1) / dim
        rows[t] -= lr * m[t] / (np.sqrt(acc[t])[:, None] + 1e-8)
    return rows


def ps_device_table(torch, cd, dps):
    """(c): ``TheOnePS`` with the Criteo table on the card."""
    ps = dps.TheOnePS()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tab = ps.create_table(0, cd.TOTAL_ROWS, cd.DIM, optimizer="adagrad",
                          lr=0.05, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    pushes = []
    for n in (2048,) * 10 + (128,) * 10:
        ids = cd.batch(rng, n)[0]
        pushes.append((ids, (0.1 * rng.standard_normal(
            (ids.size, cd.DIM))).astype(np.float32)))
    touched = np.unique(np.concatenate([p[0].ravel() for p in pushes]))
    sample = np.sort(rng.choice(touched, PS_SAMPLE, replace=False))
    untouched = np.setdiff1d(np.unique(rng.integers(
        0, cd.TOTAL_ROWS, 4 * PS_SAMPLE)), touched)[:PS_SAMPLE]
    dev = tab.device
    before_t = tab.pull(sample).cpu().numpy()
    before_u = tab.pull(untouched).cpu().numpy()
    pull_ms = {n: event_ms(torch, lambda i=torch.as_tensor(
        cd.batch(rng, n)[0]).to(dev): tab.pull(i), iters=20)
        for n in (128, 2048)}
    push_ms = {128: [], 2048: []}
    for ids, g in pushes:
        i, gg = torch.from_numpy(ids).to(dev), torch.from_numpy(g).to(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        tab.push(i, gg)
        b.record()
        b.synchronize()
        push_ms[ids.shape[0]].append(a.elapsed_time(b))
    after_t = tab.pull(sample).cpu().numpy()
    after_u = tab.pull(untouched).cpu().numpy()
    want = _adagrad_replay(before_t, sample, pushes, 0.05, cd.DIM)
    # where a push's time goes: one more push of each size, profiled
    # (after the replay's reads: it moves the rows)
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools import profile_serving as wl

    push_prof = {}
    for n in (128, 2048):
        ids = torch.from_numpy(cd.batch(rng, n)[0]).to(dev)
        g = torch.zeros((ids.numel(), cd.DIM), device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            tab.push(ids, g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        summ = wl.summarize(torch, prof, wall, 1)
        top = sorted((e for e in prof.key_averages()
                      if e.device_type != torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_cpu_time_total)[:6]
        push_prof[n] = {"wall_ms": summ["wall_ms"],
                        "device_ms": summ["device_ms"],
                        "launches": summ["launches"],
                        "host_top_ms": {e.key: e.self_cpu_time_total / 1e3
                                        for e in top}}
        log(f"  (c) one profiled push of {n} x 26: {json.dumps(push_prof[n])}")
    err = float(np.abs(after_t - want).max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    table_gb = (tab.state.rows.numel() + tab.state.accum.numel()) * 4 / 1e9
    # bound: a pull reads B x 26 rows and writes them; a push reads and
    # writes each touched row and accumulator (merge traffic ignored)
    bound = {n: 2 * n * cd.SLOTS * cd.DIM * 4 / HBM_BYTES_PER_S * 1e3
             for n in (128, 2048)}
    out = {"rows": cd.TOTAL_ROWS, "table_gb": table_gb, "init_s": init_s,
           "pull_ms": pull_ms,
           "push_ms_median": {n: _median(v) for n, v in push_ms.items()},
           "pull_bound_ms": bound, "replay_max_abs_err": err,
           "push_profiled": push_prof,
           "untouched_bit_equal": bool(np.array_equal(after_u, before_u)),
           "peak_gb": peak}
    log(f"  (c) TheOnePS on the card: {cd.TOTAL_ROWS} x {cd.DIM} "
        f"({table_gb:.3f} GB with the accumulator) drawn in {init_s:.2f} s;"
        f" pull ms 128 x 26: {pull_ms[128]:.4f}, 2048 x 26: "
        f"{pull_ms[2048]:.4f} (byte bound {bound[128]:.5f} / "
        f"{bound[2048]:.5f}); push ms median 128 x 26: "
        f"{out['push_ms_median'][128]:.4f}, 2048 x 26: "
        f"{out['push_ms_median'][2048]:.4f}; {PS_SAMPLE} touched rows vs "
        f"the float64 replay: {err:.3g}; untouched bit-equal "
        f"{out['untouched_bit_equal']}; peak {peak:.3f} GB")
    assert err <= PS_REPLAY_TOL, err
    assert out["untouched_bit_equal"]
    del tab, ps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ps_sharded_case(cd):
    """(d)'s case for ``hybrid_check``'s "ps_table" kind on a 4-rank
    ``mp`` mesh: 1/PS_SHARD_SCALE of the Criteo Kaggle rows, 10 pushes, a
    2048 x 26 pull."""
    vocab = sum(cd.rows_at(PS_SHARD_SCALE))
    rng = np.random.default_rng(2)
    pushes = []
    for n in (2048,) * 5 + (128,) * 5:
        ids = cd.batch(rng, n, scale=PS_SHARD_SCALE)[0]
        pushes.append((ids, (0.1 * rng.standard_normal(
            (ids.size, cd.DIM))).astype(np.float32)))
    pull_ids = cd.batch(rng, 2048, scale=PS_SHARD_SCALE)[0]
    return {"kind": "ps_table", "mesh": {"mp": 4}, "vocab": vocab,
            "dim": cd.DIM, "seed": 0, "pushes": pushes,
            "pull_ids": pull_ids, "gather_to": 0}


def ps_sharded(torch, cd, dps, held):
    """(d): the table row-sharded over 4 ranks against one card.  ``held``
    ({"rank0": rank 0's result, "spawn_wall_clock": the spawn's start})
    is ``ps_sharded_case(cd)`` run by ``hybrid_check.run_cases`` on four
    ranks: in the hybrid phase's spawn, or under ``--ps-only`` in
    ``ps_only``'s."""
    case = ps_sharded_case(cd)
    vocab, pushes, pull_ids = case["vocab"], case["pushes"], case["pull_ids"]
    r0, wall0 = held["rank0"], held["spawn_wall_clock"]
    m = r0["marks"]
    ranks_s = m["gathered"] - m["entered"]
    stages = {"start": m["entered"] - wall0}
    prev = m["entered"]
    for k in ("mesh", "table", "pushed", "pulled", "gathered"):
        stages[k] = m[k] - prev
        prev = m[k]
    one = dps.SparseEmbeddingTable(vocab, cd.DIM, seed=0)
    for ids, g in pushes:
        one.push(ids, g)
    n = vocab + 1            # the ranks' layout pads past V + 1 rows
    err = float(np.abs(r0["rows"][:n]
                       - one.state.rows.cpu().numpy()).max())
    want = one.state.accum.cpu().numpy()
    acc_err = float((np.abs(r0["accum"][:n] - want)
                     / (PS_SHARD_ACC_RTOL * want + 1e-7)).max())
    pull_err = float(np.abs(r0["pulls"]
                            - one.pull(pull_ids).cpu().numpy()).max())
    cards = torch.cuda.device_count()
    out = {"ranks": 4, "rows": vocab, "transport": "nccl" if cards >= 4
           else "gloo staged on card 0", "ranks_s": ranks_s,
           "max_abs_err": err, "accum_excess": acc_err,
           "pull_max_abs_err": pull_err,
           "rank0_stages_s": stages,
           "push_ms_median_rank0": _median(r0["push_ms"]),
           "pull_ms_rank0": r0["pull_ms"][0]}
    log(f"  (d) {vocab} rows over 4 ranks ({out['transport']}; the case's "
        f"own work: pushed and gathered in {ranks_s:.1f} s): gathered rows "
        f"within {err:.3g} of one card's; accumulator: largest |ranks - one card| "
        f"/ ({PS_SHARD_ACC_RTOL} one card + 1e-7) {acc_err:.3g} (gate 1); "
        f"a pull of 2048 x 26 within {pull_err:.3g}; rank 0 push ms median "
        f"{out['push_ms_median_rank0']:.3f}, pull ms "
        f"{out['pull_ms_rank0']:.3f}; rank 0's stages, s: "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    assert err <= PS_SHARD_TOL and acc_err <= 1, (err, acc_err)
    assert pull_err <= PS_SHARD_TOL, pull_err
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ps_phase(torch, ks, sharded):
    """The parameter-server phase, (a)-(d) (see the module docstring);
    the port's kernel counts are zeroed before it and must read 0
    after: no kernel lies on this path.  ``sharded``: (d)'s rank results
    (``ps_sharded``'s ``held``)."""
    import tempfile

    from paddle_tpu_torch import _native
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import heter, ps as dps, ps_service
    from paddle_tpu_torch.tools import criteo_dlrm as cd, ps_check
    from paddle_tpu_torch.tools import profile_serving as wl

    t0 = time.perf_counter()
    _native.ps_table()
    log(f"  the native table built in {time.perf_counter() - t0:.1f} s")
    zero_counts(ks)
    stats = {}
    with tempfile.TemporaryDirectory(prefix="ps_phase_") as d:
        stats["small"] = ps_small(torch, ps_check, d + "/small")
        stats["criteo_heter"] = ps_criteo_heter(torch, cd, ps_service, heter,
                                                optim, wl, d + "/criteo")
    gc.collect()
    torch.cuda.empty_cache()
    stats["device_table"] = ps_device_table(torch, cd, dps)
    stats["sharded"] = ps_sharded(torch, cd, dps, sharded)
    launches = launch_counts(ks)
    assert not any(launches.values()), launches
    stats["launches"] = launches
    stats["phase_s"] = time.perf_counter() - t0
    log(f"[parameter-server phase: {stats['phase_s']:.1f} s; kernel "
        f"launches {json.dumps(launches)}]")
    return stats


def ps_only(torch, card) -> int:
    """``--ps-only``: the parameter-server phase alone, (d)'s four ranks
    spawned first (the whole smoke runs them in the hybrid phase's
    spawn)."""
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import woq_matmul as wm
    from paddle_tpu_torch.tools import criteo_dlrm as cd, hybrid_check as hc

    log("[parameter-server services]")
    t0 = time.time()
    outs = spawn.spawn(hc.run_cases, ([ps_sharded_case(cd)],), 4)
    psstats = ps_phase(torch, counters(fa, da, fc, fn, wm),
                       {"rank0": outs[0][0], "spawn_wall_clock": t0})
    log(json.dumps({"ps": psstats}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def tp_only(torch, card) -> int:
    """``--tp-only``: the build, then the tensor-parallel serving phase
    alone."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import woq_matmul as wm
    from paddle_tpu_torch.text import engine, generate as G, gpt, serving
    from paddle_tpu_torch.text import woq
    from paddle_tpu_torch.tools import profile_serving as wl

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    ks = counters(fa, da, fc, fn, wm)
    log("[tensor- and expert-parallel serving]")
    tstats, launches, tc, tick = tp_phase(torch, gpt, G, serving, engine,
                                          ks, wl, woq)
    log(json.dumps({"tp": tstats, "launches": launches, "tc_launches": tc,
                    "tick_launches": tick}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def hybrid_only(torch, card, small_runs=True) -> int:
    """``--hybrid-only``: the build, then the hybrid-parallel phase alone
    (its one-card reference loss computed here, not taken from the train
    rungs) — what a four-card machine runs for (c) and (f);
    ``--full-width-only`` with it skips the kernel checks and (a), (d),
    (e)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch import nn as clip
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.text import gpt, gpt_hybrid
    from paddle_tpu_torch.tools import profile_train as tr

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    headline = headline_step1_loss(torch, gpt, tr)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[the headline rung's step-1 loss, one card: {headline:.5f}]")
    hstats, launches, tc, sp_launches, sp_tc, herr = hybrid_phase(
        torch, gpt, gpt_hybrid, optim, clip, tr, fa, fc, headline,
        small_runs)
    log(json.dumps({"hybrid": hstats, "launches": launches,
                    "tc_launches": tc, "sp_ep_launches": sp_launches,
                    "sp_ep_tc_launches": sp_tc, "max_abs_err": herr}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def data_comm_only(torch, card) -> int:
    """``--data-comm-only``: the build, the headline rung in memory (the
    reference of (a)), then the data and comm phase — (a), (b), and (c)'s
    rank cases in one four-rank spawn of their own."""
    from paddle_tpu_torch import nn as clip
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import env, spawn
    from paddle_tpu_torch.distributed.fleet import comm_opt as co
    from paddle_tpu_torch.ops import _build, remat_policies
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import woq_matmul as wm
    from paddle_tpu_torch.text import gpt, gpt_hybrid
    from paddle_tpu_torch.tools import hybrid_check as hc
    from paddle_tpu_torch.tools import profile_train as tr

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    ks = counters(fa, da, fc, fn, wm)
    log(f"[train path: build_gpt_train_step, rung {HYBRID_1P3B_RUNG}, in "
        f"memory]")
    ref, _ = train_path(torch, gpt, ks, tr, remat_policies,
                        HYBRID_1P3B_RUNG)
    gc.collect()
    torch.cuda.empty_cache()
    log("[data and comm: (a) reader-fed headline, (b) DGC]")
    dcstats, launches = data_comm_phase(torch, gpt, gpt_hybrid, tr, ks,
                                        remat_policies, ref)
    gc.collect()
    torch.cuda.empty_cache()
    (_, backend, _), line = hybrid_placement(torch, env)
    log(f"[data and comm (c): {line[1:-1]}]")
    cases, ctx = comm_small_cases(torch, gpt, HYBRID_SMALL_STEPS[backend])
    toks = np.random.default_rng(0).integers(
        0, gpt.gpt_1p3b().vocab_size,
        (tr.RUNGS[HYBRID_1P3B_RUNG].batch, tr.SEQ + 1))
    pipe = pipeline_1p3b_case(torch, gpt, tr, backend, toks)
    t0 = time.perf_counter()
    with shared_card_allocator(backend):
        outs = spawn.spawn(hc.run_cases, (cases + [pipe],),
                           nprocs=HYBRID_RANKS)
    spawn_s = time.perf_counter() - t0
    n = len(cases)
    cstats, cl, ctc = check_comm_small(torch, gpt_hybrid, optim, clip, hc,
                                       co, ctx, [o[:n] for o in outs])
    pstats, pl, ptc = check_pipeline_1p3b(torch, gpt, tr, hc, pipe,
                                          [o[n] for o in outs], backend)
    _add(cl, pl)
    _add(ctc, ptc)
    _add(launches, cl)
    log(json.dumps({"data_comm": dcstats, "rank_cases": cstats,
                    "pipeline_1p3b": pstats, "spawn_s": spawn_s,
                    "launches": launches, "rank_tc_launches": ctc}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if "--tp-only" in sys.argv[1:]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.tools import profile_serving as wl

        torch.backends.cuda.matmul.allow_tf32 = False
        card = wl.card_line()
        log(card)
        return tp_only(torch, card)
    if "--ps-only" in sys.argv[1:]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.tools import profile_serving as wl

        torch.backends.cuda.matmul.allow_tf32 = False
        card = wl.card_line()
        log(card)
        return ps_only(torch, card)
    if "--data-comm-only" in sys.argv[1:]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.tools import profile_serving as wl

        torch.backends.cuda.matmul.allow_tf32 = False
        card = wl.card_line()
        log(card)
        return data_comm_only(torch, card)
    if "--hybrid-only" in sys.argv[1:]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from paddle_tpu_torch.tools import profile_serving as wl

        torch.backends.cuda.matmul.allow_tf32 = False
        card = wl.card_line()
        log(card)
        return hybrid_only(torch, card,
                           "--full-width-only" not in sys.argv[1:])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import remat_policies
    from paddle_tpu_torch.ops import woq_matmul as wm
    from paddle_tpu_torch import nn as clip
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.optimizer import lr as lrs
    from paddle_tpu_torch.text import generate as G
    from paddle_tpu_torch.text import engine
    from paddle_tpu_torch.text import gpt, gpt_hybrid, kv_pool, lora, serving
    from paddle_tpu_torch.text import woq
    from paddle_tpu_torch.tools import profile_serving as wl
    from paddle_tpu_torch.tools import profile_train as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = wl.card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[kernels vs plain twins]")
    err = {"flash_attention_fwd": check_flash(torch, fa),
           "decode_attention": max(check_decode(torch, da),
                                   check_decode_wide(torch, da)),
           "paged_decode_attention": check_paged(torch, da)}
    err["flash_attention_bwd_dq"], err["flash_attention_bwd_dkv"] = \
        check_flash_bwd(torch, fa)
    err["fused_ce_fwd"], err["fused_ce_bwd"] = check_ce(torch, fc)
    err["fused_layer_norm_fwd"], err["fused_layer_norm_bwd"] = \
        check_norm(torch, fn)
    err["w4_matmul"] = check_w4(torch, wm, woq)

    log("[decode paths on the card vs the CPU]")
    check_path_vs_cpu(torch, gpt, G, serving)
    check_paged_path_vs_cpu(torch, gpt, G, kv_pool, serving)
    log("[weight-only int8 / int4 models on the card vs the CPU]")
    check_quantized_vs_cpu(torch, gpt, G, serving, woq, wm)
    log("[served through graphs vs eager steps, admission included: small "
        "fp32 models]")
    check_graphs_vs_eager(torch, gpt, serving, woq, engine)
    log("[the device feed: card vs CPU counts on small fp32 models]")
    from paddle_tpu_torch import telemetry as tl
    t_feed = time.perf_counter()
    feed_small = feed_small_vs_cpu(torch, gpt, serving, woq, tl)
    t_feed = time.perf_counter() - t_feed
    log(f"  every step's FLOPs and bytes the CPU's, steps compared: "
        f"{json.dumps(feed_small)} ({t_feed:.1f} s)")
    log("[train steps on the card vs the CPU]")
    check_train_vs_cpu(torch, gpt, gpt_hybrid, optim.AdamW, fn)
    log("[remat, dropout, Adafactor, Lamb, clipping, a schedule: train "
        "steps on the card vs the CPU, remat bit-equal to none]")
    check_train_surface_vs_cpu(torch, gpt, gpt_hybrid, optim, clip, lrs)
    log("[MoE training: router noise under a key, remat and drops — train "
        "steps on the card vs the CPU, remat bit-equal to none]")
    moe_small = moe_train_small_vs_cpu(torch, gpt, gpt_hybrid, optim)
    log(f"  {json.dumps(moe_small)}")

    log("[kernel timings at the paths' shapes]")
    flash_by_t = {T: time_flash(torch, fa, F, T) for T in (64, 128, 256, 512)}
    for T, row in flash_by_t.items():
        log(f"  flash_attention_fwd {json.dumps(row)}")
    # decode at mid-serve: every slot halfway through its new tokens
    dec = time_decode(torch, da, F, [n + wl.NEW // 2 for n in wl.LENS])
    dec.update(route=da.route(1, torch.bfloat16, 128),
               chunk_nsplit=da.tick_plan(len(wl.LENS), 16, 512, 1))
    log(f"  decode_attention {json.dumps(dec)}")
    dec_chunk = time_decode_chunk(torch, da, F)
    log(f"  decode_attention admission chunk {json.dumps(dec_chunk)}")
    # a speculative verify at mid-serve: K = SPEC_K rows a slot (G = 1:
    # R = K, the tick body)
    verify_pos = [n + wl.NEW // 2 for n in wl.LENS]
    dec_verify = time_decode(torch, da, F, verify_pos, Tq=SPEC_K)
    dec_verify.update(route=da.route(SPEC_K, torch.bfloat16, 128))
    log(f"  decode_attention verify {json.dumps(dec_verify)}")
    # the paged serve's admission widths (G = 1: R = C)
    dec_widths = {f"R={R}": time_decode_chunk(torch, da, F, Tq=R)
                  for R in (128, 256)}
    for row in dec_widths.values():
        log(f"  decode_attention admission chunk {json.dumps(row)}")
    paged_lens = [len(p) for p in wl.paged_prompts(50304)]
    paged = time_paged(torch, da, F, [n + wl.NEW // 2 for n in paged_lens])
    paged.update(route=da.paged_route(1, torch.bfloat16, 128),
                 chunk_nsplit=da.tick_plan(len(paged_lens), 16, 512, 1))
    log(f"  paged_decode_attention {json.dumps(paged)}")
    # the paged serve's admission widths, one slot's chunk ending at its
    # 512th row (as the decode kernel's widths above)
    paged_widths = {}
    for C in (128, 256):
        row = time_paged(torch, da, F, [512 - C], Tq=C)
        row.update(route=da.paged_route(C, torch.bfloat16, 128),
                   chunk_nsplit=da.tc_split_plan(1, 16, 512, C))
        paged_widths[f"C={C}"] = row
        log(f"  paged_decode_attention admission chunk {json.dumps(row)}")
    paged_verify = time_paged(torch, da, F, verify_pos, Tq=SPEC_K)
    paged_verify.update(route=da.paged_route(SPEC_K, torch.bfloat16, 128))
    log(f"  paged_decode_attention verify {json.dumps(paged_verify)}")
    # the tables' cost: the paged kernel on the contiguous kernel's memory
    tick_pos = [n + wl.NEW // 2 for n in paged_lens]
    paged_addr = {"tick": time_paged_addressing(torch, da, tick_pos),
                  "C=128": time_paged_addressing(torch, da, [384], Tq=128)}
    log(f"  paged_decode_attention on contiguous memory "
        f"{json.dumps(paged_addr)}")
    if not all(r["bits_equal"] for r in paged_addr.values()):
        raise AssertionError("the paged kernel on the contiguous kernel's "
                             "memory gave other bits")
    flash_train = time_flash(torch, fa, F, tr.SEQ)
    log(f"  flash_attention_fwd at the train shape {json.dumps(flash_train)}")
    bwd = time_flash_bwd(torch, fa, F, tr.SEQ)
    ce = time_ce(torch, fc, F)
    ln = time_norm(torch, fn, F)
    # a tick (N = 8) and the admission buckets up to the cap, at every
    # gpt_1p3b weight shape; the first row is the kernels line's
    w4_rows = {f"N={N} K={K} M={M}": time_w4(torch, wm, woq, N, K, M)
               for N in (8, 64, 128, 256) for K, M in W4_SHAPES}
    for name, row in (("flash_attention_bwd_dq", bwd["dq"]),
                      ("flash_attention_bwd_dkv", bwd["dkv"]),
                      ("fused_ce_fwd", ce["fwd"]),
                      ("fused_ce_bwd", ce["bwd"]),
                      ("fused_layer_norm_fwd", ln["fwd"]),
                      ("fused_layer_norm_bwd", ln["bwd"]),
                      *(("w4_matmul", r) for r in w4_rows.values())):
        log(f"  {name} {json.dumps(row)}")
    ks = counters(fa, da, fc, fn, wm)
    by_path = {}

    log("[main path: DecodeServer, gpt_1p3b, contiguous KV]")
    stats, by_path["main"] = main_path(torch, gpt, G, serving, engine, ks,
                                       wl)
    log(json.dumps({"main_path": stats}))

    log("[paged path: DecodeServer(layout='paged'), gpt_1p3b]")
    pstats, by_path["paged"] = paged_path(torch, gpt, G, serving, engine,
                                          ks, wl)
    log(json.dumps({"paged_path": pstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[budgeted serve: the main path, prefill_budget={BUDGET}, "
        f"staggered arrivals]")
    bstats = budgeted_path(torch, gpt, engine, wl)
    log(json.dumps({"budgeted_serve": bstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[generate: gpt_1p3b, batch 8, 64-token prompts, 32 new tokens]")
    gstats = generate_path(torch, gpt, G, serving, engine)
    log(json.dumps({"generate": gstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[speculation: GPT-1.3B, K = {SPEC_K}]")
    sstats, by_path["speculation"] = spec_phase(torch, gpt, G, serving,
                                                engine, ks, wl)
    log(json.dumps({"speculation": sstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[beam search: GPT-1.3B, 2 prompts x 64 tokens, num_beams 4, 32 "
        "new]")
    bmstats, by_path["beam"] = beam_phase(torch, gpt, G, engine, ks)
    log(json.dumps({"beam": bmstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[pressure: gpt_1p3b — the paged spill tier under six waves of chat "
        "traffic; the OOM ladder, wedge, real OOM, TTL and NaN drills]")
    prstats, by_path["pressure"] = pressure_phase(torch, gpt, serving,
                                                  engine, ks, wl)
    log(json.dumps({"pressure": prstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[overload: admission control on GPT-1.3B main]")
    ostats, by_path["overload"] = overload_phase(torch, gpt, engine, ks, wl,
                                                 card)
    log(json.dumps({"overload": ostats}))

    gc.collect()                    # the bf16 serving models leave the card
    torch.cuda.empty_cache()
    log("[W4 path: DecodeServer, gpt_1p3b int4 weights, W4 kernel]")
    wstats, by_path["w4"] = w4_path(torch, gpt, G, serving, woq, wm, engine,
                                    ks, wl)
    log(json.dumps({"w4_path": wstats}))
    log(f"  beside the main path (bf16 weights, this run): tokens/s "
        f"{wstats['tokens_per_s']:.1f} vs {stats['tokens_per_s']:.1f}, mean "
        f"tick {wstats['tick_ms_mean']:.2f} vs {stats['tick_ms_mean']:.2f} "
        f"ms, peak memory {wstats['peak_mem_gb']:.2f} vs "
        f"{stats['peak_mem_gb']:.2f} GB")

    gc.collect()
    torch.cuda.empty_cache()
    log("[the trees the other phases bypass: int8 KV and GQA on main and "
        "paged, int4 weights on paged, the pressure drills on the int4 tree "
        "and on a speculating server: GPT-1.3B]")
    t_trees = time.perf_counter()
    trstats, by_path["trees"] = trees_phase(
        torch, gpt, serving, woq, wm, engine, ks, wl,
        {"main": stats, "paged": pstats})
    t_trees = time.perf_counter() - t_trees
    log(json.dumps({"trees": trstats}))
    log(f"[the feed checks, the trees' phase and the sampled tree serve: "
        f"{t_feed + t_trees + sstats['sampled_tree_s']:.1f} s of command "
        f"time — feed checks on small models {t_feed:.1f} s, the trees' "
        f"phase {t_trees:.1f} s, the sampled tree serve "
        f"{sstats['sampled_tree_s']:.1f} s]")

    gc.collect()                    # the dense models leave the card
    torch.cuda.empty_cache()
    log(f"[MoE serving: GPT-1.3B widths, {MOE_E} experts top-{MOE_K} — (a) "
        f"small fp32 models card vs CPU, (b) full width fp32 at the "
        f"dropless cf {MOE_E / MOE_K} against the dense-eval reference, (c) "
        f"full width bf16 at cf {MOE_CF}, main and paged]")
    mstats, by_path["moe"] = moe_phase(torch, gpt, G, serving, engine, ks,
                                       wl, da)
    log(json.dumps({"moe": mstats}))

    gc.collect()                    # the MoE models leave the card
    torch.cuda.empty_cache()
    log(f"[multi-tenant serving: (a) small fp32 models with a 3-adapter pool "
        f"card vs CPU, constraints and speculation; (b) GPT-1.3B under a "
        f"{ADAPTER_N}-adapter rank-{ADAPTER_RANK} pool, main and paged, "
        f"eager then graphed; (c) GPT-1.3B under a JSON schema]")
    astats, by_path["adapters"] = adapters_phase(torch, gpt, G, serving,
                                                 engine, ks, wl)
    log(json.dumps({"adapters": astats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[evaluation: nll vs cached_nll, GPT-1.3B bf16 on 4 x 513 tokens, "
        "int8 KV; a small fp32 model card vs CPU]")
    t_eval = time.perf_counter()
    evstats, by_path["evaluate"] = evaluate_phase(torch, gpt, ks)
    log(json.dumps({"evaluate": evstats}))
    log(f"[the multi-tenant phase {astats['phase_s']:.1f} s, evaluation "
        f"{time.perf_counter() - t_eval:.1f} s]")

    gc.collect()
    torch.cuda.empty_cache()
    log("[the serving fleet: (a) small fp32 fleets card vs CPU — loopback, "
        "streamed and whole, fp32 and int8 KV, socket, add/remove, "
        "autoscale, chain migration; (b) GPT-1.3B on the JAX bench's mixed "
        "schedule, one server vs 2 replicas + 1 prefill worker; (c) the "
        "paged fleet; (d) the wedge drill]")
    flstats, by_path["fleet"] = fleet_phase(torch, gpt, serving, engine, ks,
                                            wl)
    log(json.dumps({"fleet": flstats}))
    log(f"[the fleet phase {flstats['phase_s']:.1f} s, its small models "
        f"{flstats['small_s']:.1f} s]")

    train = {}
    for path, rung, twin in TRAIN_RUNGS:
        gc.collect()                # the last model leaves the card
        torch.cuda.empty_cache()
        log(f"[train path: build_gpt_train_step, rung {rung}]")
        train[path], by_path[path] = train_path(torch, gpt, ks, tr,
                                                remat_policies, rung)
        log(json.dumps({f"{path}_path": train[path]}))
    for path, rung, twin in TRAIN_RUNGS:
        a, b = train[twin or "train"], train[path]
        if path == "train":
            continue
        log(f"  {rung} vs {a['rung']}, this run: steady "
            f"{b['steady_step_ms']:.1f} vs {a['steady_step_ms']:.1f} "
            f"ms/step, {b['steady_tokens_per_s']:.0f} vs "
            f"{a['steady_tokens_per_s']:.0f} tokens/s, MFU {b['mfu']:.4f} "
            f"vs {a['mfu']:.4f} (routed {b['mfu_routed']:.4f} vs "
            f"{a['mfu_routed']:.4f}), peak memory {b['peak_mem_gb']:.4f} vs "
            f"{a['peak_mem_gb']:.4f} GB (requested "
            f"{b['peak_requested_gb']:.4f} vs {a['peak_requested_gb']:.4f}; "
            f"micro-batches "
            f"{b['peak_micro_batches_gb']:.2f} vs "
            f"{a['peak_micro_batches_gb']:.2f}, update "
            f"{b['peak_update_gb']:.2f} vs {a['peak_update_gb']:.2f}), a "
            f"micro-batch's forward keeps {b['forward_kept_gb']:.3f} vs "
            f"{a['forward_kept_gb']:.3f} GB")
        # remat trades recompute for the activations a forward keeps; the
        # step's peak is the optimizer update's, which remat cannot lower,
        # so there it must only not rise.  A dense twin holds the
        # allocated peak; an MoE twin the bytes the program asked for
        # (requested): its allocated peak also holds the caching
        # allocator's unsplit block tails, which follow the cache's
        # history, and came out up to 1 MiB apart at an equal requested
        # peak
        peak = ("peak_requested_gb" if "moe" in tr.RUNGS[rung].cfg
                else "peak_mem_gb")
        if twin and not (b["forward_kept_gb"] < a["forward_kept_gb"]
                         and b[peak] <= a[peak]):
            raise AssertionError(
                f"{rung}: a forward keeps {b['forward_kept_gb']} GB and the "
                f"step's {peak} is {b[peak]} GB (allocated "
                f"{b['peak_mem_gb']}, requested {b['peak_requested_gb']}), "
                f"against {a['forward_kept_gb']} and {a[peak]} GB "
                f"({a['peak_mem_gb']}, {a['peak_requested_gb']}) for "
                f"{a['rung']}")

    gc.collect()
    torch.cuda.empty_cache()
    log("[data and comm: (a) the headline rung fed from token shards on disk "
        "(QueueDataset -> TokenShardReader -> DevicePrefetcher) against the "
        "in-memory run; (b) DGC at GPT-1.3B's gradients and card vs CPU; "
        "(c) in the hybrid phase's spawns]")
    dcstats, by_path["data_comm"] = data_comm_phase(
        torch, gpt, gpt_hybrid, tr, ks, remat_policies, train["train_fused"])
    dc_tc = tc_counts(ks)
    log(json.dumps({"data_comm": dcstats}))

    gc.collect()
    torch.cuda.empty_cache()
    log("[LoRA: small fp32 LoRA and QLoRA-int8 runs card vs CPU; the LoRA "
        "rung, GPT-1.3B widths, fp32 base frozen, rank 8 on the attention, "
        "AdamW, 4 x 2048 tokens, fused CE]")
    t_lora = time.perf_counter()
    lora_small = lora_small_vs_cpu(torch, gpt, lora, optim, woq)
    log(f"  {json.dumps(lora_small)}")
    lstats, by_path["lora"] = lora_rung(torch, gpt, ks, tr, optim,
                                        train["train_fused"])
    lstats["small_vs_cpu"] = lora_small
    log(json.dumps({"lora_path": lstats}))
    log(f"[LoRA: {time.perf_counter() - t_lora:.1f} s]")

    gc.collect()
    torch.cuda.empty_cache()
    from paddle_tpu_torch.tools import criteo_dlrm
    hstats, hyb, tc_hyb, hyb_sp, tc_hyb_sp, herr = hybrid_phase(
        torch, gpt, gpt_hybrid, optim, clip, tr, fa, fc,
        train["train_fused"]["losses"][0],
        ps_case=ps_sharded_case(criteo_dlrm))
    ps_held = hstats.pop("ps_sharded")
    log(json.dumps({"hybrid": hstats}))
    _add(by_path["data_comm"], hstats["data_comm_launches"])
    _add(dc_tc, hstats["data_comm_tc_launches"])
    by_path["hybrid"] = {name: hyb.get(name, 0) for name in ks}
    by_path["hybrid_sp_ep"] = {name: hyb_sp.get(name, 0) for name in ks}
    for name, e in herr.items():
        err[name] = max(err[name], e)
    ce_shard = time_ce(torch, fc, F, V=25152)
    log(f"  fused_ce at a vocab shard (mp 2) {json.dumps(ce_shard)}")


    ln["bwd"].update(ln_bwd_apart(torch, fn))
    log(f"  fused_layer_norm_bwd apart: rows_ms {ln['bwd']['rows_ms']:.4f}, "
        f"cols_ms {ln['bwd']['cols_ms']:.4f} (ms {ln['bwd']['ms']:.4f})")

    # last: its rank processes share the card, and nothing after it
    # profiles
    gc.collect()
    torch.cuda.empty_cache()
    log("[tensor- and expert-parallel serving: (a) + (e) small fp32 models, "
        "speculation and an adapter pool at mp2; (b) GPT-1.3B widths at mp2 "
        "and mp4, main and paged; (c) int4 build_sharded_decode at mp2; (d) "
        "the 8-expert MoE model at ep2 x mp2, and its fp32 twin]")
    tpstats, tp_l, tp_tc, tp_tick = tp_phase(torch, gpt, G, serving, engine,
                                             ks, wl, woq)
    log(json.dumps({"tp": tpstats}))
    by_path["tp"] = {name: tp_l.get(name, 0) for name in ks}

    gc.collect()
    torch.cuda.empty_cache()
    log("[parameter-server services: (a) a device table and a small "
        "HeterTrainer, card vs CPU; (b) the Criteo Kaggle table on two host "
        "servers, DLRM on the card; (c) the table on the card; (d) "
        "row-sharded over 4 ranks]")
    psstats = ps_phase(torch, ks, ps_held)
    log(json.dumps({"ps": psstats}))

    tc_by_path = {"main": stats["tc_launches"], "paged": pstats["tc_launches"],
                  "w4": wstats["tc_launches"],
                  "pressure": prstats["tc_launches"],
                  "overload": ostats["ladder"]["tc_launches"],
                  "speculation": sstats["tc_launches"],
                  "beam": bmstats["tc_launches"],
                  "trees": trstats["tc_launches"],
                  "moe": mstats["tc_launches"],
                  "adapters": astats["tc_launches"],
                  "evaluate": evstats["tc_launches"],
                  "lora": lstats["tc_launches"],
                  "fleet": flstats["tc_launches"],
                  "hybrid": {name: tc_hyb.get(name, 0)
                             for name in stats["tc_launches"]},
                  "hybrid_sp_ep": {name: tc_hyb_sp.get(name, 0)
                                   for name in stats["tc_launches"]},
                  "tp": {name: tp_tc.get(name, 0)
                         for name in stats["tc_launches"]},
                  "data_comm": {name: dc_tc.get(name, 0)
                                for name in stats["tc_launches"]},
                  **{p: t["tc_launches"] for p, t in train.items()}}
    assert all(by_path[p]["decode_attention"] == 0
               for p in (*train, "lora", "data_comm"))
    tick_by_path = {name: {"main": stats["tick_launches"][name],
                           "paged": pstats["tick_launches"][name],
                           "w4": wstats["tick_launches"][name],
                           "pressure": prstats["tick_launches"][name],
                           "overload": ostats["ladder"]["tick_launches"][
                               name],
                           "speculation": sstats["tick_launches"][name],
                           "beam": bmstats["tick_launches"][name],
                           "trees": trstats["tick_launches"][name],
                           "moe": mstats["tick_launches"][name],
                           "adapters": astats["tick_launches"][name],
                           "evaluate": evstats["tick_launches"][name],
                           "fleet": flstats["tick_launches"][name],
                           "lora": 0, "hybrid": 0, "hybrid_sp_ep": 0,
                           "data_comm": 0,
                           "tp": tp_tick.get(name, 0),
                           **{p: 0 for p in train}}
                    for name in ("decode_attention", "paged_decode_attention")}

    tc_bodies = {
        "flash_attention_fwd": "paddle_tpu_torch/csrc/attn_tc.cuh",
        "decode_attention": "paddle_tpu_torch/csrc/decode_chunk_tc.cuh "
        "(attn_tc.cuh's tile body)",
        "paged_decode_attention": "paddle_tpu_torch/csrc/decode_chunk_tc.cuh "
        "(attn_tc.cuh's tile body, the pool read in place)",
        "flash_attention_bwd_dq": "paddle_tpu_torch/csrc/flash_bwd.cu "
        "(tc::dq_kernel, on attn_tc.cuh's primitives)",
        "flash_attention_bwd_dkv": "paddle_tpu_torch/csrc/flash_bwd.cu "
        "(tc::dkv_kernel, on attn_tc.cuh's primitives)",
        "w4_matmul": "paddle_tpu_torch/csrc/woq_matmul.cu "
        "(w4tc::w4_tc_kernel, on attn_tc.cuh's primitives)"}

    def entry(name, src, replaces, row, **extra):
        launches = {p: counts[name] for p, counts in by_path.items()}
        if name in tc_by_path["main"]:
            tc = {p: counts[name] for p, counts in tc_by_path.items()}
            extra = {"tc_launches": sum(tc.values()),
                     "tc_launches_by_path": tc,
                     "tc_body": tc_bodies[name], **extra}
        if name in tick_by_path:
            extra = {"tick_launches": sum(tick_by_path[name].values()),
                     "tick_launches_by_path": tick_by_path[name],
                     "tick_body": "paddle_tpu_torch/csrc/decode_tick.cuh",
                     **extra}
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": err[name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], **extra}

    w4_main, *w4_more = w4_rows.values()
    kernels = [
        entry("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_fwd.cu",
              "paddle_tpu/ops/flash_attention.py:164", flash_by_t[512],
              at_train_shape=flash_train),
        entry("flash_attention_bwd_dq", "paddle_tpu_torch/csrc/flash_bwd.cu",
              "paddle_tpu/ops/flash_attention.py:249", bwd["dq"]),
        entry("flash_attention_bwd_dkv", "paddle_tpu_torch/csrc/flash_bwd.cu",
              "paddle_tpu/ops/flash_attention.py:302", bwd["dkv"]),
        entry("fused_layer_norm_fwd", "paddle_tpu_torch/csrc/fused_norm.cu",
              "paddle_tpu/ops/fused_norm.py:144", ln["fwd"]),
        entry("fused_layer_norm_bwd", "paddle_tpu_torch/csrc/fused_norm.cu",
              "paddle_tpu/ops/fused_norm.py:202", ln["bwd"],
              rows_ms=ln["bwd"]["rows_ms"], cols_ms=ln["bwd"]["cols_ms"]),
        entry("fused_ce_fwd", "paddle_tpu_torch/csrc/fused_ce.cu",
              "paddle_tpu/ops/fused_ce.py:159", ce["fwd"],
              at_vocab_shard=ce_shard["fwd"]),
        entry("fused_ce_bwd", "paddle_tpu_torch/csrc/fused_ce.cu",
              "paddle_tpu/ops/fused_ce.py:200", ce["bwd"],
              at_vocab_shard=ce_shard["bwd"]),
        entry("w4_matmul", "paddle_tpu_torch/csrc/woq_matmul.cu",
              "paddle_tpu/ops/woq_matmul.py:157", w4_main,
              at_other_shapes=w4_more),
        entry("decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
              "paddle_tpu/ops/decode_attention.py:282", dec,
              at_admission_chunk=dec_chunk,
              at_admission_widths=dec_widths, at_verify=dec_verify),
        entry("paged_decode_attention",
              "paddle_tpu_torch/csrc/paged_decode_attention.cu",
              "paddle_tpu/ops/decode_attention.py:509", paged,
              gather_ms=paged["gather_ms"],
              at_admission_widths=paged_widths,
              on_contiguous_memory=paged_addr, at_verify=paged_verify),
    ]
    log(f"[whole smoke: {time.perf_counter() - t_start:.1f} s after "
        f"the card's query]")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
