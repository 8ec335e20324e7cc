#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line (any failure raises and
exits non-zero; with no CUDA device it exits 2 before printing a result):

1. device: the card as nvidia-smi names it, torch/CUDA versions; then
   every kernel of the port is built with nvcc from csrc/ for sm_90a,
   each kernel's registers and spills as ptxas -v reports them (a spill
   in a tensor-core body, any "_mma_kernel" of K1-K3, K5-K11 and K14-K16,
   or in any paged_decode function of K4 and K4q, fails the run).
2. kernels: each kernel against its plain PyTorch version on the card
   (the GPT-2 and the Llama serving shapes, GQA, fp32, cache-position
   edges with an all-null row, NaN planted past the live pages, a null
   page inside a live split and a whole split of null pages): the
   kernels split the table (split_plan's pages per split) and are held
   to the plain version split alike, and to its one walk at
   UNSPLIT_ATOL. Then the
   kernel, plain version
   and one-library-call yardstick timed at the serving shapes (median of
   CUDA-event-timed calls, L2 flushed before each) beside the bound and
   the former body's time, and the kernel at PPS_SWEEP's pages per split.
   The same for the paged-decode kernel's int8-pool arity at the Llama
   serving shapes (9 rows, 8 kv heads, groups of 4, head_dim 64, page
   16, 64-page tables, one scale per token row, bf16 q), at the GPT-2
   serving shapes (16 kv heads, G 1), and with G 1, head_dim 128, 2 and
   4 scale blocks, page 8, fp32 q, all-null rows,
   garbage payload under NaN scales past each row's position, a
   position past the table and two rows sharing prefix pages; element
   by element (INT8_TOL), with controls that must fail the same check:
   the plain version with the scales left out, and the dense arity's
   habits (bf16 values, probabilities rounded to bf16). Both arities'
   time against context length (all rows at 16, 256, 1024 tokens), at
   split_plan's split and at each of PPS_SWEEP, the ms per walked page
   beside the former body's.
3. serving: GPT-2 345M at full width (random weights from seed 0), bf16,
   default inference config: warmup (the engine's program set captured
   as CUDA graphs), then 16 greedy requests of 64 new tokens with
   prompts of 20-250 tokens, 8 sharing one 64-token prefix. Checks every
   output, that the paged-decode kernel ran once per layer per decode
   dispatch (counted through the graphs' replays), that a graph holds
   every program and that none was built after warmup
   (``steady_state_recompiles`` 0; phases 4, 10-12, 41 and 43-45 check
   and print the same, each program with its dispatches and replays).
   Then a torch.profiler window over 8 decode steps: device busy and
   idle share per step, and the kernels that take the time.
4. kernel path against plain path through the model: an fp32 engine of
   the same model, one decode step from one prefilled state with the
   kernel and with the plain gather attention; logits compared.
5. train_kernel_check: the masked-flash kernels K1 (o, lse), K2 (dq) and
   K3 (dk, dv) against their plain versions on the card, at the training
   shapes (B 8, H 16, S 1024, D 64, bf16, causal, block 128) with
   dropout 0 and 0.1, and on a dense mask, GQA (Hkv 4, G 4, D 128), fp32,
   and per-head layouts with empty rows at block 16; for the bf16
   tensor-core bodies of K1, K2 and K3 also causal walks of 16, 32 and
   64 at head dims 64, 72 and 32, and GQA G 4 at head dim 40. Element by
   element (TRAIN_TOL), and at the training shapes and those walks a
   control: the plain versions with the bf16 rounding of p and ds left
   out must fail the same check. Every check row names the bodies K1, K2
   and K3 ran ("body", "dq_body" and "dkv_body": "mma" in bf16, "fma" in
   fp32), and a bf16 launch that ran another body fails it; every timing
   row names each kernel's body, and K2's, K3's, K6's and K7's rows the
   time of their former CUDA-core bf16 body ("fma_body_ms").
6. train_kernel_timing: K1, K2 and K3 timed at the training shapes (L2
   flushed before each call) beside their bound (the FLOP of the causal
   cells, not of the whole diagonal tiles), their plain versions and
   the library yardstick (scaled_dot_product_attention forward for K1,
   its backward for K2+K3 together), K2 and K3 beside their former
   CUDA-core bf16 times.
7. training: GPT-2 345M at full width (random weights from seed 0),
   bf16 over fp32 masters, Adam lr 1e-4, batch 8 x 1024 through
   deepspeed_tpu_torch.initialize: 2 warm-up and 10 timed train_batch
   steps on one repeated batch; step time, tokens/s, MFU, peak memory,
   every loss. Checks finite, falling losses, that K1, K2 and K3 each
   launched 24 times per step, and that every launch of K1, K2 and K3
   ran its tensor-core body (launches_by_body; so in every bf16 training
   phase below, for K1-K3 and K5-K7). Then a torch.profiler window
   over 2 more steps (device time by kernel group, device idle share)
   and the tied LM head's forward and backward timed alone.
8. training_dropout: the same model at dropout 0.1 for 3 steps (the
   attention dropout inside K1-K3): finite losses, 24 launches per step.
9. train_kernel_vs_plain: loss and every grad of a 2-layer full-width
   GPT-2 in fp32, the kernel path against the plain path.
Phases 10 to 12 run after phase 4, before the training phases.
10. llama serving: the LLAMA_1B geometry (hidden 2048, 16 layers, 32
   heads over 8 kv heads, vocab 32128, nothing cut; random weights from
   seed 0), bf16, the default inference config, the same 16 requests:
   once over the bf16 pool (the dense paged-decode kernel at G 4) and
   once over the int8 pool (its int8 arity), each with the checks of
   phase 3 and a decode profile; the pools' bytes per token and the
   share of greedy tokens on which the two runs agree.
11. Llama model path: the same Llama in fp32, 4 layers deep, one prefill
   and 3 decode steps with the kernel and with the plain gather
   attention, over the fp32 pool (logits compared) and over the int8
   pool (logits and pools compared).
12. GPT-2 345M over the int8 pool, 8 requests (G 1 on the main path),
   then a decode profile as in phase 3.
Phases 43 to 45 run after phase 12 on GPT-2 345M, and 43 and 44 again
at the end of phase 10 on Llama-1B: the serving levers.
43. graph_vs_eager: a bf16 engine with every program kind (prefill,
   decode at table widths 16, 32 and 64, verify at width 5, chunk of
   128 tokens), on live serving state: one dispatch of each replayed
   from its CUDA graph, then run eagerly from a copy of the pool as it
   was; the live rows' logits and the pool past the null page bitwise
   equal, K4's launches counted alike (GPT-2 over the bf16 pool, Llama
   over the int8 pool).
44. spec_decode_serving: phase 3's requests with spec_decode (n-gram,
   k 4). In fp32 (GPT-2) greedy tokens equal the spec-off run's but at a
   near-tie (TIE_GAP, each divergence printed with the gap); in bf16 the
   acceptance rate, proposed and accepted drafts, verify and decode
   dispatches, decode tokens/s and TTFT beside phase 3's (10's) row and
   the share of tokens equal to it; zero accepted drafts fails; K4 once
   per layer per plain decode dispatch.
45. chunked_prefill_serving: GPT-2 345M in fp32, 256-token chunks, 8
   prompts of 600-900 tokens (past the largest prompt bucket, 256): first
   tokens and logits (MODEL_LOGIT_ATOL) against an engine prefilling whole
   prompts at a 1024 bucket, tokens equal but at near-ties; then with
   speculation too. Chunk dispatches and TTFT.
Phases 46 to 49 run after phase 45 on GPT-2 345M, and 47 and 49 again at
the end of phase 10 on Llama-1B: the rest of the serving engine. Each
prints its programs with their dispatches and replays and fails unless a
CUDA graph holds each and steady_state_recompiles is 0.
46. disagg_serving: phase 3's requests under inference.disagg over the
   shared pool, over separate pools (a handoff_export/handoff_import
   migration per request) and over separate pools with spec_decode. In
   fp32 the tokens equal the plain engine's but at a near-tie (TIE_GAP),
   every handoff is claimed, only the live prompt pages move, the
   dispatch trace puts no decode behind a prefill and both pools drain
   exactly; in bf16 TTFT p50/p95 and its handoff part, the handoff queue
   and transfer ms, bytes moved, decode tokens/s and K4's launches beside
   phase 3's row.
47. quantized_weights_serving: quantize_weights "int8" in bf16 over the
   bf16 and the int8 pool, 8 of phase 3's requests: tokens and the first
   decode step's logits bitwise those of the same engine served the
   dequantized tree; the quantized forward's max logit error against the
   unquantized tree recorded through record_quant_logit_err;
   weight_bytes beside weight_bytes_dense and the bf16 weights' bytes,
   decode tokens/s and step ms beside phase 3's (10's) and 12's rows;
   K4 (K4q) once per layer per decode dispatch. After phase 41,
   quantized_from_checkpoint: from_checkpoint of global_step3 with
   quantize_weights "bf16" and "int8" serves phase 41's requests bitwise
   as an engine of run B's step-3 params shipped alike.
48. dense_cache_serving: paged_kv.enabled false (one max_len row per slot
   and a scratch row) on phase 3's requests: in fp32 tokens equal the
   paged engine's but at a near-tie, no K4 launch (the dense decode
   attends in plain fp32, as JAX's does); in bf16 the KV bytes, decode
   step ms, decode tokens/s and TTFT beside phase 3's row.
49. generate: gpt2_generate / llama_generate, 8 prompts of 128 tokens,
   64 new tokens, greedy: K1 once per layer per call (24 and 16, on its
   tensor-core body in bf16) and no other attention kernel; in fp32 the
   tokens equal the serving engine's greedy tokens for the same prompts
   but at a near-tie; ms per token in bf16.
Phases 50 and 52 run after phase 49 on GPT-2 345M (all 24 layers, seed
0), phase 51 after phase 41 on its tags: the serving fleet.
50. fleet_serving: two in-process fp32 replicas (default config,
   warm_migration) behind a prefix_affinity FleetRouter; phase 3's first
   8 requests, one router step, replica 1 drained twice (one episode),
   then the other 8. Every uid answers once, at least one request
   migrates alive (migrate_export, migrate_import), the pages each
   import wrote are bitwise the exported slabs, greedy tokens equal the
   fp32 reference's but at a near-tie, nothing shed, no program built
   after warmup, K4 once per layer per decode dispatch; decode tokens/s
   and TTFT beside phase 3's, migrations, bytes, ms export-to-import.
51. fleet_swap: two bf16 replicas of run B's step-3 params;
   swap_weights(d, "global_step6"): both report global_step6 and so does
   every later FinishedRequest, their live parameters are bitwise the
   step-6 params, phase 41's requests give its step-6 tokens but at a
   near-tie; the swap ms of each replica.
52. fleet_process: two replica_worker children on the card (fp32,
   init_seed 0, health plane on), child 0 armed with
   DSTPU_FAULT_ARM=serve.replica_kill:crash:1, a process-mode router
   (max_restarts 1): 8 requests of 32 new tokens, half sampled at 0.7.
   Child 0 exits 85 mid-decode, its deathbed exports are imported by
   child 1, it relaunches under a new pid, its flight file is salvaged;
   every uid once; greedy tokens equal the fp32 reference's but at a
   near-tie, sampled ones the parent's own fp32 engine's; each child's
   K4 launches (its own count, from its state) equal its decode
   dispatches x 24. Spawn-to-hello and death-to-relaunch seconds, peak
   memory per child, migration bytes and ms from the deathbed frame.
Phases 53 and 54 run after phase 52, on GPT-2 345M as the megatron
example builds it (vocab 50304, dropout 0, all 24 layers, seed 0, seq
1024): ZeRO-Offload, and ZeRO 2 over a process group made by the port's
launcher (multi-rank ZeRO cannot run on one card: NCCL refuses two ranks
on one device; the CPU tests hold dp 2 on gloo against JAX).
53. zero_offload_train: examples/megatron_gpt2/ds_config_offload.json
   (stage 2, cpu_offload, micro batch 4, bf16, Adam, WarmupLR, clipping
   1.0) on 4 batches: (a) with overlap_comm false against the stage-0
   device Adam of the same optimizer, schedule and clipping (the losses
   of steps 0-1 bitwise, step 2's within OFFLOAD_LOSS_ATOL; the host
   masters after 3 steps: every entry within OFFLOAD_TOL's atol of
   2 x the lrs, the share beyond the fp32 tolerance and each leaf's
   update against the device Adam's, each beside what a host Adam that
   updates nothing or steps the wrong way would read), the masters on
   the host and no Adam moment on the card, the fourth step split into
   device fwd/bwd, grad D2H, host prep, the C++ Adam and the param H2D;
   (b) as held (overlap_comm): after windows 1-3 the params are bitwise
   the initial ones, (a)'s after its step 1 and (a)'s after its step 2
   (which differ from its after steps 1 and 3), and synchronize()
   applies every update. Step ms of the three runs, peak memory against
   the stage-0 run, the host Adam's GB/s, SIMD width and OpenMP threads;
   K1-K3 24 launches a step, all "mma".
54. zero_launch: python -m deepspeed_tpu_torch.launcher.runner
   --num_gpus 1 --supervise --max_restarts 1 --restart_backoff 0
   chip_smoke.py --child zero2 <file>: the child exits 85 before it
   builds anything, is relaunched once, joins NCCL at world 1 and trains
   3 steps of examples/megatron_gpt2/ds_config_zero2.json as held (at
   one data rank ZeRO 2 takes stage 0's step, whose collective over the
   group is the grads' all-reduce), then runs the ZeRO partition's
   reduce-scatter and all-gather on NCCL with each leaf as one chunk,
   which must give the identity; the launcher exits 0, and the child's
   losses are bitwise this process's run of the same config, batches
   and seed with no group; the child's seconds from spawn to its first
   step and its K1-K3 launches (24 a step).
Phases 36 to 38 run after phase 9, before phase 13: Llama training,
K1-K3 at G 4 (32 q heads over 8 kv heads) on the training path.
36. llama_train_kernel_vs_plain: the LLAMA_1B widths at 2 layers, fp32,
   seq 1024, batch 2: llama_loss_fn's loss and every grad through K1-K3
   against their plain versions, then with remat=True against the
   non-remat kernel path (loss rtol 1e-5, grads 1e-4 of each grad's
   max); K1-K3's launches in both modes (remat: K1 twice per layer),
   each on the fp32 body.
37. llama_training: LLAMA_1B (16 layers, nothing cut, random weights from
   seed 0) with examples/llama/ds_config_zero2.json as held (micro batch
   8, bf16 over fp32 masters, Adam betas 0.9/0.95, weight decay 0.1,
   WarmupLR, clipping 1.0, ZeRO 2) at seq 1024 and
   observability.enabled (events_dir in a temporary directory), the
   example's synthetic ids: 2 warm-up and 10 timed steps (step ms,
   tokens/s, peak memory, K1-K3's launches per step, all on the
   tensor-core body, MFU by PERF.md's formula and by the Observer's
   counted FLOPs, side by side); a profile of 2 more (idle share, time
   by group, the optimizer's foreach passes apart) and the fp32 head
   alone; tools/obs_report.py's summary of the events log must give the
   step count, a step time, an MFU, the FLOPs per step and the peak
   memory; then 2 steps of the trained weights under remat=True
   (launches per step, step ms).
38. llama_gqa_kernel_timing: K1, K2 and K3 alone at the Llama step's
   shape (B 8, H 32, kv heads 8, S 1024, D 64, bf16, causal, block 128),
   held against their plain versions (TRAIN_TOL, with the rounding
   control), then timed as in phase 6 beside the bound, one plain call,
   SDPA with enable_gqa=True, and K3's group sum of its fp32 per-q-head
   partials on its own line.
Phases 13 to 17 run after phase 38.
13. bert_kernel_check: K1, K2 and K3 in their key-mask arity (BERT's
   additive padding mask, -1e9 on the pads) against their plain versions
   on the card: BERT-large's attention (B 8, H 16, S 128, D 64, bf16,
   dense, block 128, real lengths 64-128) at dropout 0 and 0.1, S 512
   with lengths 256-512, a batch row whose keys are all pads, GQA (Hkv
   4, G 4, D 128), fp32 at block 64, and a causal mask under the key
   mask. Control: the plain versions without the key mask must fail the
   same check on every output.
14. bert_kernel_timing: the three at S 128 and S 512, timed as in phase
   6, beside the bound, the plain version and SDPA with the same float
   (B, 1, 1, S) mask.
15. bert_training: BERT-large (nothing cut, random weights from seed 0)
   with examples/bing_bert/ds_config.json as the repo holds it (Lamb,
   WarmupLR, clipping 1.0, ZeRO 1, micro batch 8, ga 2, bf16 over fp32
   masters, dropout 0.1) on padded synthetic MLM batches: 2 warm-up and
   10 timed steps at seq 128 (step ms, samples/s, real tokens/s, MFU,
   peak memory, losses, lrs, Lamb coefficients), a profile of 2 more,
   then 3 timed steps at seq 512. Checks finite losses, the lr of each
   step against WarmupLR.lr_at, the coefficients inside [0.01, 0.3], and
   48 key-mask launches of each kernel per step and no mask-free one.
16. bert_kernel_vs_plain: a 2-layer full-width BERT-large in fp32 on a
   padded batch, the kernel path against the plain path.
Phases 17 to 20 run after phase 16: block-sparse BERT-large
(examples/bing_bert/train.py --mode sparse at seq 2048, the position
table extended from 512 by SparseAttentionUtils) in two configurations:
ds_config_sparse.json as the repo holds it (fixed, per-head layouts at
block 16: K1-K3's key-mask arity at walk 16 with 16 mask heads) and its
sparse_attention section replaced by {"mode": "bslongformer"} (the
schema's defaults: K1-K3's key-mask arity at the fine walk of 16 with one
mask head, the walk rule's pick, masked_flash.walk_cost_us).
17. sparse_kernel_check: K1, K2 and K3 in their band arity against their
   plain versions on the card (TRAIN_TOL): B 8, H 16, S 2048, D 64,
   bf16, the BSLongformer layout at walk 128, 64 and 32 with the sparse
   route's key mask (lengths 1024-2048, -1e30 on the pads), dropout 0.1,
   fp32, a causally clipped band, and walked BAND tiles with rows and
   columns that keep no cell beside a batch row of pads. Control: the
   plain versions with the BAND tiles taken as FULL must fail the same
   check on every output.
18. sparse_kernel_timing: the three at the fixed layouts (walk 16) and
   the BSLongformer layout at walk 128, 64, 32 and 16, timed as in phase
   6, beside the bound (bytes, or the fine layout's FLOP), the plain
   version and SDPA with the dense float (B, H, S, S) mask; the
   BSLongformer sweep fitted to the walk cost model (walk_cost_fit).
19. bert_sparse_training: each configuration, 1 warm-up and 3 timed
   train_batch steps on padded synthetic MLM batches (step ms,
   samples/s, real tokens/s, MFU beside the layout's density, peak
   memory, losses, lrs), then a profile of 1 more. Checks finite losses,
   the lrs, the Lamb coefficients, and 48 launches per step of each
   kernel, all in the one arity the layout gives (printed).
20. bert_sparse_kernel_vs_plain: phase 16 with sparse attention, the
   fixed configuration at seq 512 and the BSLongformer one at 2048.
Phases 21 to 23: block-sparse attention under a user (S, S) attention
mask, the row-run kernels K8 (forward), K9 (dq) and K10 (dk, dv), at B 8,
H 16, S 2048, D 64, bf16, the layouts of ds_config_sparse.json as held,
the sparse route's key mask (lengths 1024-2048) and a 'mul' mask made
from the seed.
21. v2_kernel_check: K8-K10 against their plain versions on the card
   (TRAIN_TOL) at that shape and the walk the rule picks (the plain calls
   timed once), then at S 512: 'add' mode with finite values, the BigBird
   layout under a causal keep mask, fp32, forced coarse walks of 64 and
   128, mask rows that drop every key beside a batch row of pads, a
   bf16 walk of 128 at head dim 128 (two CTAs share each tile), and a
   row whose only keys sit at -5e28. Control: the plain versions with the
   mask tiles left out must fail the same check on every output; at the
   main shape also the plain forward with p's bf16 rounding left out
   (fp32 inputs) must fail it on o, and the plain backward on fp32
   copies (neither ds nor K10's p rounded to bf16) on dq and dk; on the
   -5e28 row the plain backward with v1's threshold of -1e28 on dq and
   dk. Every row names the three kernels' bodies ("body", "dq_body",
   "dkv_body": "mma" in bf16, on K1's, K2's and K3's tensor-core bodies;
   "fma" in fp32) and the cells K9's and K10's tensor-core bodies summed
   again (their count and share of the walked cells), and a bf16 launch
   that ran another body fails it (so in phases 22, 23, 25 and 26 for
   K8-K10, and 32-35 for K14-K16).
22. v2_kernel_timing: the three at the main shape at the fine walk and
   every coarse walk the tile budget admits, timed as in phase 6, beside
   the bound, the plain version and SDPA with the dense float
   (B, H, S, S) mask, each beside its former CUDA-core bf16 time
   ("fma_body_ms"); the sweep fitted to the walk cost model. Then
   v2_walk_picks: the three together on six small layouts (S 128-512)
   whose walk hangs on the costs, at every admitted walk, beside the
   rule's pick.
23. sparse_self_attention: the entry point, SparseSelfAttention with the
   config's sparse_attention section, forward and backward of a scalar
   loss (1 warm-up, 3 timed): ms, peak memory, one launch of each of
   K8-K10 per call (each on its tensor-core body) and none of K1-K3; a
   2-head fp32 call on the kernel
   path against the plain path; and masked_flash_attention over the
   mask of a BSLongformer window of 5 blocks at a walk of 128, asked for
   through make_block_mask (the walk rule keeps the fine walk since
   K1-K3 all run on the tensor cores): K1-K3's band arity.
Phases 24 to 27: the legacy sparse dispatch (blocksparse.USE_MASKED_FLASH
= False, restored after), which JAX's sparse_attention_speedup_s8k row
pins, at its geometry (B 1, H 16, S 8192, D 64, bf16, fine block 128):
BSLongformer with a window of 3 blocks runs the banded kernels K11
(forward), K12 (dq) and K13 (dk, dv), in bf16 on K1's, K2's and K3's
tensor-core bodies, their serial walks split (K11's and K12's
global-rows instances over their kv tiles, gr_split_plan; K13's
global-columns instance over its q tiles, dkv_split); BigBird's
defaults run the hybrid (K11-K13 on the band, K8-K10 without a mask tile
on the 928 residual blocks, merged by their lse).
24. banded_kernel_check: K11-K13, every instance, against their plain
   versions on the card (TRAIN_TOL): the s8k BSLongformer layout at the
   rule's tiles, sparse BERT's BSLongformer (B 8, H 16, S 2048, block 16)
   with its key mask, and JAX's eight geometries at S 512 at tiles
   (64, 128) and (128, 64), bf16 and fp32, with batch rows of pads; then
   the split walks at forced splits (BANDED_SPLIT_CASES: one tile a
   split, uneven last splits, a causal walk, global rows and columns
   wider than a tile, one warp a CTA, with and without a key mask). The
   split instances are held to the plain versions split as the kernels
   split them; in bf16 K11's global rows also to the one walk's within
   SPLIT_TOL, each kernel must run its tensor-core body, and K12 and K13
   must sum again as many cells split as in one walk (their tallies).
   Control: the plain versions with the keep predicate dropped must fail
   every output.
25. v2_nomask_kernel_check: K8-K10 without a mask tile against their
   plain versions: the BigBird residue at the s8k geometry, and the fixed
   layouts of ds_config_sparse.json at S 2048, fine and at a forced coarse
   walk of 64 (structural tiles). Controls as in phase 21 (the tiles left
   out; without tiles the key mask left out, or fp32 inputs).
26. legacy_sparse_timing: at both layouts, K11-K13 per instance and
   summed, timed as in phase 6, beside the bound, one plain call, SDPA
   with the dense float mask (the library column), SDPA is_causal=True
   (the dense baseline of JAX's row), K1-K3 on the masked route, and
   each kernel's former CUDA-core time per instance (FORMER_BANDED); for
   BigBird K8-K10 without a mask tile (each beside its former CUDA-core
   bf16 time) and the merge; the split walks (K11's and K12's gr, K13's
   gc) at the tiles per split of KPS_SWEEP and their plans', at the s8k
   and sparse BERT's shapes; a sweep of walk tiles at both shapes,
   fitted to walk_cost_us (kernels "banded"), with the refit's picks
   timed beside the rule's. Then SparseSelfAttention forward and backward
   under the legacy and the default dispatch: ms, peak memory and
   launches per call (BSLongformer 2, 2, 3 of K11, K12, K13 and nothing
   else; BigBird the same and one of each of K8-K10, all on their
   tensor-core bodies).
27. bert_sparse_training_legacy: phase 19's BSLongformer configuration
   under the legacy dispatch, 1 warm-up and 3 timed steps and a 1-step
   profile (each of K11-K13's ms per step in it): 96, 96 and 144
   launches of K11, K12, K13 per step (all on their tensor-core bodies)
   and none of K1-K3; then phase 20's kernel-vs-plain check of it.
Phases 28 to 31: the legacy dense flash route
(set_attention_options(kernel="flash"), restored after), the kernels K5
(forward), K6 (dq) and K7 (dk, dv), at the card's tiles (bq from seq_q, bk
from seq_k, each the widest of 128, 64, 32, 16 that divides it).
28. flash_kernel_check: K5-K7 against their plain versions on the card
   (TRAIN_TOL), bf16 and fp32: the GPT-2 shape (B 8, H 16, S 1024, D 64,
   causal) at dropout 0 and 0.1, BERT-large's padding mask at S 128 and
   S 512 with a batch row of pads, GQA at the LLAMA_1B geometry (32 q
   heads over 8 kv heads, S 1024, causal), causal with seq_q 512 < seq_k
   1024 (the keys no query reaches take dk = dv = 0) and 1024 > 512 (the
   capped walk; in fp32 also o against attention_reference), and tiles of
   32 at head_dim 24; for the bf16 tensor-core bodies of K5, K6 and K7
   also tiles (64, 128) with seq_q 320 < seq_k 1024, (128, 32) with
   1024 > 160 at head dim 40 under GQA 4 and the key mask, tiles of 16
   at head dim 32, of 32 at head dim 72, and head dim 128 under GQA 4.
   Each row names the three bodies ("body", "dq_body", "dkv_body"), and
   a bf16 launch that ran another body than "mma" fails it. Controls
   (on these cases too): the plain versions without the rounding of
   p and ds, without the key mask or without the causal clip must fail
   the same check on every output.
29. flash_kernel_timing: K5-K7 at the GPT-2 shape and at the s8k dense
   geometry (B 1, H 16, S 8192, D 64, bf16, causal), each first held
   against its plain versions on the inputs it is timed on (as in phase
   28, with the rounding control), timed as in phase 6, beside the bound
   (the causal cells' FLOP), the check's one timed plain call, SDPA
   is_causal=True, K1-K3 on the default route and, for K6 and K7, their
   former CUDA-core bf16 times; then flash_attention(causal=True)
   forward and backward
   at the s8k geometry under the knob and under the default route (ms,
   peak memory, launches), the dense side of JAX's
   sparse_attention_speedup_s8k beside phase 26's legacy sparse calls.
30. training_legacy: phase 7 under the knob (2 warm-up, 10 timed steps,
   no profile): step ms, tokens/s, MFU, peak memory, exactly 24 launches
   of each of K5-K7 per step and none of K1-K3, the losses beside phase
   7's; then 3 steps at dropout 0.1 (training_dropout_legacy) and phase
   9's kernel-vs-plain check (train_kernel_vs_plain_legacy).
31. bert_training_legacy: phase 15 under the knob at seq 128, 1 warm-up
   and 3 timed steps: K5-K7's key-mask arity, 48 launches of each per
   step and none of K1-K3; then phase 16's kernel-vs-plain check
   (bert_kernel_vs_plain_legacy).
Phases 32 to 35: the v1 block-sparse kernels
(blocksparse.USE_SPLASH_V2 = False, restored after), K14 (forward), K15
(dq) and K16 (dk, dv), on JAX's three paths to them: a user attention
mask (JAX's oracle for K8-K10), the legacy dispatch without a mask on the
fixed layouts (sparse BERT's key mask), and the s8k row's v1 fallback
(no mask, USE_BANDED = False).
32. v1_kernel_check: K14-K16 against their plain versions on the card
   (TRAIN_TOL; lse within LSE_ATOL, NEG_INF on empty block rows in both):
   (a) B 8, H 16, S 2048, D 64, bf16, the fixed layouts at block 16, the
   sparse route's key mask and a 'mul' mask keeping 90%; (b) the same
   without the attention mask; (c) the s8k geometry without masks,
   BSLongformer (window 3) and BigBird at block 128, the plain calls of
   (a)-(c) timed once; (d) at S 512, blocks 32, 64 and 128, bf16 and
   fp32: 'add' masks of finite values, one row whose only keys sit at
   -5e28, a hand-made layout with an empty block row and column, a batch
   row of pads. Controls that must fail the same check on every output:
   the plain versions with the attention mask left out (else the key
   mask, else on fp32 inputs), in (d) with the threshold at -1e29, and
   at (a) and (b) the plain forward with p's bf16 rounding left out (on
   o) and the plain backward on fp32 copies, neither ds nor K16's p
   rounded to bf16 (on dq and dk). Every row names the three kernels'
   bodies (as phase 21 does K8's) and the cells K15's and K16's
   tensor-core bodies summed again (their count and share of the walked
   cells).
33. v1_kernel_timing: the three at (a), (b) and both layouts of (c),
   timed as in phase 6, beside the bound (bytes moved once, the mask's
   once per distinct tile of the heads' union, or the layout's FLOP),
   the plain call of phase 32, SDPA with the dense float (B, H, S, S)
   mask, K8-K10 on the same inputs and each kernel's former CUDA-core
   bf16 time.
34. v1_entry_point: SparseSelfAttention with the config's section, the
   key mask and an (S, S) 'mul' mask under USE_SPLASH_V2 = False at (a),
   forward and backward (1 warm-up, 3 timed): ms, peak memory, exactly
   one launch of each of K14-K16 per call (each on its tensor-core body)
   and no other attention kernel;
   a 2-head fp32 call against the v1 plain path (TRAIN_TOL fp32) and the
   default route's K8-K10 (JAX's v2-vs-v1 tolerance); then bench.py's v1
   fallback at the s8k geometry for both layouts, beside phase 26's
   legacy calls and phase 29's dense side.
35. bert_sparse_training_v1: phase 19's fixed configuration under
   USE_MASKED_FLASH = False and USE_SPLASH_V2 = False, 1 warm-up and 3
   timed steps and a 1-step profile (K14-K16's ms per launch there beside
   phase 33's (b) times on randn inputs): 48 launches of each of K14-K16
   per step, all of the key-mask arity and on their tensor-core bodies,
   and no other attention kernel; the
   losses beside phase 19's; then phase 20's kernel-vs-plain check of it
   at seq 2048.
Phases 40 to 42 run after phase 38, before phase 13: checkpoints, in a
temporary directory deleted at the end (its free space and file system
printed first; too little space fails the run).
40. checkpoint_resume: GPT-2 345M (all 24 layers, dropout 0.1) with
   examples/megatron_gpt2/ds_config_zero2.json as held (micro batch 8,
   bf16 over fp32 masters, Adam, WarmupLR, clipping 1.0, ZeRO 2), seq
   1024, observed, on 6 batches of ids from seed 0. Run A takes them
   straight under the trace window (observability.trace at steps 2-3:
   the Chrome trace must hold their train_batch labels only and 48
   launches of each of K1-K3); run A2 again, for the spread. Run B takes
   3 and saves; a new engine from other weights and another seed loads
   the directory (every param and moment bitwise B's at the save), takes
   3 more (losses equal to A's bitwise, or within A's spread against A2)
   and saves again. K1-K3 launch 24 times a step, all "mma"; the port's
   verify CLI passes both tags; obs_report reads 2 saves, 1 load and 1
   resume. The tag's bytes, the snapshot, write, CRC-verify and load
   times, the step time.
41. serve_from_checkpoint: InferenceEngine.from_checkpoint of
   global_step3 over the bf16 pool serves 4 greedy requests (prompts of
   128, 32 new tokens): tokens and the first decode step's logits bitwise
   those of an engine of run B's in-memory params at step 3; then
   swap_params to global_step6: the same against the step-6 params, at
   weight_version global_step6, ordinal 1; K4 once per layer per decode
   step, none of K4q.
42. checkpoint_fallback: a bit flipped in global_step6's model shard: the
   CRC32 check names it, a swap to it raises and the engine keeps serving
   global_step6's weights (the same tokens), and a new engine's
   load_checkpoint() falls back to global_step3 (bitwise B's params at
   step 3) with a fallback row that obs_report counts.
39. the {"kernels": [...]} line (K1-K3 with their launches on the GPT-2
   and the Llama training paths (and phases 40, 53 and 54's, the last
   counted in its child) and their Llama-shape
   times of phase 38, K1 with phase 49's calls, K4 with phase 41's,
   phase 44's and phase 46's plain decode dispatches and K4 and K4q with
   phase 47's,
   with the three key-mask, the three
   band, the three row-run, the three banded, the three no-mask
   row-run, the three legacy flash entries and K14-K16 in each of their
   three arities on the paths above; each with its "body": "mma" for
   K1-K3, K5-K11 and K14-K16 in bf16, "fma" for the rest; K11 with its
   former CUDA-core time, its split and the split sweep),
   K1 with its s8k default-route time from phase 29), the nvidia-smi
   line, and last {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, NamedTuple

import numpy as np

SEED = 0
NEW_TOKENS = 64
SHARED_PREFIX = 64
BF16_ATOL = 2e-3     # summation order differs; p is rounded to bf16
FP32_ATOL = 1e-5     # summation order differs
MODEL_LOGIT_ATOL = 1e-3   # fp32, 24 layers of differently ordered sums
# speculation and chunked prefill against their plain runs in fp32: a
# greedy token may differ only where the plain run's top two logits were
# closer than this (the verify and chunk dispatches run the gather
# attention, the plain decode the paged-decode kernel: other sums)
TIE_GAP = 1e-3
SPEC_DECODE = {"spec_decode": {"enabled": True, "k": 4}}
# chunked_prefill_serving: 8 prompts past the largest default prompt
# bucket (256), served through 256-token chunks
CHUNK_LENGTHS = (600, 645, 690, 735, 780, 825, 870, 900)
CHUNK_NEW_TOKENS = 16
CHUNKED = {"chunked_prefill": {"enabled": True, "chunk_tokens": 256}}
# the split paged-decode kernels against the plain version's one walk of
# the table (JAX's): each split restarts the running max, so in bf16 p
# rounds against another max on the split's pages (the CPU tests hold the
# split plain version to JAX at this tolerance)
UNSPLIT_ATOL = 2e-2
# K4's and K4q's former one-block-per-(row, kv head) body, which walked
# its pages one after another (PERF.md section 6, its context sweep;
# chip_smoke.py runs on an NVIDIA H100 80GB HBM3 at 700 W): ms at the
# serving shapes and ms per walked page, printed beside this run's
FORMER_PAGED = {"paged_decode": {"kernel_ms": 0.15987,
                                 "ms_per_walked_page": 0.00293},
                "paged_decode_int8": {"kernel_ms": 0.48296,
                                      "ms_per_walked_page": 0.00842}}
# pages per split timed beside split_plan's (64 = the whole 64-page table)
PPS_SWEEP = (1, 2, 4, 8, 16, 64)
TIMED_CALLS = 100
# K2's, K3's, K6's, K7's, K8-K10's and K14-K16's times on their former
# CUDA-core bf16 bodies (these timing phases on an NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md section 6), printed beside this run's as "fma_body_ms":
# (phase, kernel, case) -> ms
FMA_BODY_MS = {
    ("train_kernel_timing", "masked_flash_dq", "gpt2"): 4.14640,
    ("bert_kernel_timing", "masked_flash_dq_kpm", "S128"): 0.20816,
    ("bert_kernel_timing", "masked_flash_dq_kpm", "S512"): 2.00520,
    ("sparse_kernel_timing", "masked_flash_dq", "fixed walk16"): 6.95846,
    ("sparse_kernel_timing", "masked_flash_dq",
     "bslongformer walk128"): 3.42058,
    ("sparse_kernel_timing", "masked_flash_dq",
     "bslongformer walk64"): 3.20027,
    ("sparse_kernel_timing", "masked_flash_dq",
     "bslongformer walk32"): 3.19542,
    ("sparse_kernel_timing", "masked_flash_dq",
     "bslongformer walk16"): 2.49768,
    ("flash_kernel_timing", "flash_dq", "gpt2"): 3.28840,
    ("flash_kernel_timing", "flash_dq", "s8k"): 20.72018,
    ("train_kernel_timing", "masked_flash_dkv", "gpt2"): 4.36955,
    ("bert_kernel_timing", "masked_flash_dkv_kpm", "S128"): 0.25824,
    ("bert_kernel_timing", "masked_flash_dkv_kpm", "S512"): 2.56090,
    ("sparse_kernel_timing", "masked_flash_dkv", "fixed walk16"): 10.52250,
    ("sparse_kernel_timing", "masked_flash_dkv",
     "bslongformer walk128"): 3.73098,
    ("sparse_kernel_timing", "masked_flash_dkv",
     "bslongformer walk64"): 3.66483,
    ("sparse_kernel_timing", "masked_flash_dkv",
     "bslongformer walk32"): 3.82651,
    ("sparse_kernel_timing", "masked_flash_dkv",
     "bslongformer walk16"): 3.30699,
    ("flash_kernel_timing", "flash_dkv", "gpt2"): 4.61899,
    ("flash_kernel_timing", "flash_dkv", "s8k"): 30.46237,
    ("v2_kernel_timing", "blocksparse_v2_fwd", "fixed walk16"): 7.28334,
    ("v2_kernel_timing", "blocksparse_v2_fwd", "fixed walk32"): 8.16910,
    ("v2_kernel_timing", "blocksparse_v2_fwd", "fixed walk64"): 15.15061,
    ("v2_kernel_timing", "blocksparse_v2_fwd", "fixed walk128"): 16.35938,
    ("legacy_sparse_timing", "blocksparse_v2_fwd", "bb residue"): 0.54816,
    ("v2_kernel_timing", "blocksparse_v2_dq", "fixed walk16"): 7.36739,
    ("v2_kernel_timing", "blocksparse_v2_dq", "fixed walk32"): 15.21290,
    ("v2_kernel_timing", "blocksparse_v2_dq", "fixed walk64"): 30.38771,
    ("v2_kernel_timing", "blocksparse_v2_dq", "fixed walk128"): 30.11758,
    ("legacy_sparse_timing", "blocksparse_v2_dq", "bb residue"): 0.94062,
    ("v2_kernel_timing", "blocksparse_v2_dkv", "fixed walk16"): 9.56698,
    ("v2_kernel_timing", "blocksparse_v2_dkv", "fixed walk32"): 16.56102,
    ("v2_kernel_timing", "blocksparse_v2_dkv", "fixed walk64"): 33.39506,
    ("v2_kernel_timing", "blocksparse_v2_dkv", "fixed walk128"): 33.34456,
    ("legacy_sparse_timing", "blocksparse_v2_dkv", "bb residue"): 1.19162,
    ("v1_kernel_timing", "bs_fwd", "a"): 6.73406,
    ("v1_kernel_timing", "bs_fwd", "b"): 6.59600,
    ("v1_kernel_timing", "bs_fwd", "lf"): 5.28358,
    ("v1_kernel_timing", "bs_fwd", "bb"): 5.46877,
    ("v1_kernel_timing", "bs_dq", "a"): 7.21648,
    ("v1_kernel_timing", "bs_dq", "b"): 6.97048,
    ("v1_kernel_timing", "bs_dq", "lf"): 6.94032,
    ("v1_kernel_timing", "bs_dq", "bb"): 7.60243,
    ("v1_kernel_timing", "bs_dkv", "a"): 9.99971,
    ("v1_kernel_timing", "bs_dkv", "b"): 9.84358,
    ("v1_kernel_timing", "bs_dkv", "lf"): 7.76722,
    ("v1_kernel_timing", "bs_dkv", "bb"): 8.34845,
}
# masked flash, kernel against plain version, element by element:
# |a - b| <= atol + rtol * |b|, and in bf16 also over the whole tensor:
# ||a - b|| <= rms * ||b||. In bf16 both sides round the same fp32
# values (p before P.V, ds before its products, the outputs), summed in
# another order, so an element may land one bf16 ulp (rtol 2**-7) apart;
# atol covers elements near zero. The same check applied to a plain
# version with the rounding of p and ds left out must fail on every
# output (the control of train_kernel_check). fp32: only the sum order
# differs.
TRAIN_TOL = {"bf16": dict(atol=1e-4, rtol=2.0**-7, rms=1e-3),
             "fp32": dict(atol=1e-5, rtol=1e-4, rms=None)}
# the int8 paged-decode kernel against its plain version, element by
# element, |a - b| <= atol + rtol * |b|: every product is fp32 in both
# and only the sum order differs; with bf16 q the output's rounding may
# land one bf16 ulp (2**-7 relative) apart
INT8_TOL = {"bf16": dict(atol=1e-4, rtol=2.0**-7, rms=None),
            "fp32": dict(atol=1e-5, rtol=1e-4, rms=None)}
# the kernel path's and the plain path's sums differ in order, so past
# the first layer a value may sit on the other side of an int8 rounding
# step: at most this share of the payload values the run wrote, by one
# step (3 of 3.1e6 on an H100), and a scale may differ in its last bits
INT8_POOL_FLIP_SHARE = 1e-5
INT8_POOL_SCALE_RTOL = 1e-5
LSE_ATOL = 1e-3           # lse is fp32 in both: differently ordered sums
# K11's split gr walk against the plain one walk on the global rows, bf16:
# per element |a - b| <= atol + rtol * (max |v| + |b|), and the relative
# RMS error of those rows within rms. Each split rounds p to bf16 under
# its own running max, so a p may round to the other neighbour (2**-7 of
# p at most) and o = sum p v / l part by 2**-7 max |v|, beside o's own
# rounding; two independent roundings of p part by 3.2e-3 of p in RMS,
# and o by about as much of o (tests/test_torch_banded_split.py holds the
# split plain version to JAX's one walk so, and measures 1.3e-3 to 2.8e-3)
SPLIT_TOL = dict(atol=1e-4, rtol=2.0**-7, rms=2.0**-7)
# the fp32 2-layer model, kernel path against plain path: loss relative
# error and each grad's error relative to the grad's largest entry
TRAIN_MODEL_LOSS_RTOL = 1e-5
TRAIN_MODEL_GRAD_TOL = 1e-4
# the same for BERT's MLM loss, whose head rounds its operands to bf16
# (bert_kernel_vs_plain_phase): one bf16 ulp of each grad's largest entry
BERT_HEAD_GRAD_TOL = 2.0 ** -8
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
# by card (NVIDIA data sheets): device-memory bytes/s, dense bf16 FLOP/s
# on the tensor cores, fp32 FLOP/s outside them
CARD_PEAKS = (("H200", 4.8e12, 989e12, 67e12),
              ("H100 NVL", 3.9e12, 835e12, 60e12),
              ("H100 PCIe", 2.0e12, 756e12, 51e12),
              ("H100", 3.35e12, 989e12, 67e12))


# main()'s start: each phase row carries the seconds since it ("t_s"),
# so a run's log shows where the script's time limit goes
_START = None


# every phase row emitted so far (later phases print earlier ones' numbers)
ROWS = []


def emit(obj):
    if _START is not None and "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _START, 1))
    if "phase" in obj:
        ROWS.append(obj)
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_peaks(name: str, ops: str = "bf16"):
    """(bytes/s, FLOP/s of ``ops``: "bf16" or "fp32") of the card
    nvidia-smi named."""
    for key, bytes_per_s, bf16, fp32 in CARD_PEAKS:
        if key in name:
            return bytes_per_s, bf16 if ops == "bf16" else fp32
    raise RuntimeError(f"no peak rates on record for {name!r}")


# ------------------------------------------------------------- kernels
def dense_layout_mask(layout, block):
    """``blocksparse.layout_additive_mask(layout, block)`` as an fp32
    (H, S, S) tensor on the card, expanded there (the same values: 0
    where the layout keeps a block, NEG_INF elsewhere); at the s8k
    geometry the host's expansion takes seconds and 4 GB."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import NEG_INF
    keep = torch.from_numpy(np.asarray(layout) != 0).cuda()
    keep = keep.repeat_interleave(block, -2).repeat_interleave(block, -1)
    return torch.where(keep, 0.0, NEG_INF).float()


def pool_case(rng, batch, kv_heads, group, hd, page_size, pages_per_seq,
              positions, null_rows=(), poison=True):
    """Numpy inputs of one paged-decode call: distinct non-null pages per
    row, NaN in every page past a row's live count."""
    num_pages = batch * pages_per_seq + 1
    kpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    vpool = rng.randn(num_pages, kv_heads, page_size, hd).astype(np.float32)
    q = rng.randn(batch, kv_heads * group, hd).astype(np.float32)
    tables = 1 + rng.permutation(num_pages - 1)[:batch * pages_per_seq]
    tables = tables.reshape(batch, pages_per_seq).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    for b in range(batch):
        if poison and b not in null_rows:
            dead = tables[b, pos[b] // page_size + 1:]
            kpool[dead] = np.nan
            vpool[dead] = np.nan
    for b in null_rows:
        tables[b] = 0
    return q, kpool, vpool, tables, pos


def to_device(case, dtype):
    import torch
    q, kpool, vpool, tables, pos = case
    return (torch.from_numpy(q).to("cuda", dtype),
            torch.from_numpy(kpool).to("cuda", dtype),
            torch.from_numpy(vpool).to("cuda", dtype),
            torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())


def split_of(args):
    """(pages per split, splits) of the paged-decode kernels for these
    arguments (q, kpool, vpool, tables, ...), by split_plan."""
    from deepspeed_tpu_torch.ops.attention.paged import split_plan
    q, kpool, tables = args[0], args[1], args[3]
    B, H, hd = q.shape
    _, KH, ps, _ = kpool.shape
    P = tables.shape[1]
    pps = split_plan(B, KH, H // KH, hd, ps, P)
    return pps, -(-P // pps)


def check_kernel(name, args, atol, null_rows=()):
    """The dense kernel against its plain version split alike (``atol``)
    and against the plain version's one walk (UNSPLIT_ATOL)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    pps, splits = split_of(args)
    ref = paged_decode_plain(*args, pages_per_split=pps)
    whole = paged_decode_plain(*args)
    err = float((out.float() - ref.float()).abs().max())
    err_whole = float((out.float() - whole.float()).abs().max())
    finite = bool(torch.isfinite(out).all())
    nulls_zero = all(bool((out[b] == 0).all()) for b in null_rows)
    emit({"phase": "kernel_check", "case": name,
          "dtype": str(args[0].dtype), "shape_q": list(args[0].shape),
          "shape_pool": list(args[1].shape), "pages_per_split": pps,
          "splits": splits, "max_abs_err": err, "atol": atol,
          "max_abs_err_unsplit": err_whole, "atol_unsplit": UNSPLIT_ATOL,
          "finite": finite, "null_rows_zero": nulls_zero})
    if not (finite and nulls_zero and err <= atol and
            err_whole <= UNSPLIT_ATOL):
        raise AssertionError(f"paged decode kernel disagrees on {name}: "
                             f"err {err} (atol {atol}), against the one "
                             f"walk {err_whole} (atol {UNSPLIT_ATOL}), "
                             f"finite {finite}, null rows zero {nulls_zero}")
    return err


# cycles the card spins (~0.2 ms) while the host enqueues a held call
HOLD_CYCLES = 400_000


def time_ms(fn, calls, flush, warmup=3, hold=False):
    """Median ms of ``calls`` CUDA-event-timed calls after ``warmup``
    calls, the L2 cache flushed before each. ``hold`` keeps the card busy
    (``torch.cuda._sleep``) past the flush while the host enqueues the
    call, so a host slower than the flush adds no idle time to the
    window: for calls whose device time is a fraction of their host time
    (the paged-decode kernels: ~0.03 ms on the card, ~0.05 ms of Python
    and launch on the host)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timed_call(fn, flush):
    """fn()'s result and the CUDA-event ms of that one call, the L2 cache
    flushed before it."""
    import torch
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


CONTEXTS = (16, 256, 1024)


def at_context(args, n):
    """``args`` (inputs at the main-path shape whose rows are written up
    to the table's extent; element 4 holds the positions) with every
    live row at context ``n``."""
    import torch
    args = list(args)
    live = args[3][:, 0] != 0
    args[4] = torch.where(live, n - 1, 0).to(torch.int32)
    return args


def context_sweep(args, page_size, flush, pages_per_split=None):
    """The kernel's time against context length (CONTEXTS), every live
    row at the same context, L2 flushed before each call; returns the
    rows and the ms per walked page (the slope between the ends)."""
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    rows = []
    for n in CONTEXTS:
        ctx = at_context(args, n)
        ms = time_ms(lambda: paged_decode_attention(
            *ctx, pages_per_split=pages_per_split), 50, flush, hold=True)
        rows.append({"context_tokens": n, "pages": n // page_size,
                     "kernel_ms": ms})
    per_page = ((rows[-1]["kernel_ms"] - rows[0]["kernel_ms"])
                / (rows[-1]["pages"] - rows[0]["pages"]))
    return rows, per_page


def split_sweep(kernel, serving, full, page_size, flush, smi):
    """K4's or K4q's time at the serving inputs and over the context
    sweep at each of PPS_SWEEP pages per split and at split_plan's, and
    the context sweep at split_plan's (its ms per walked page beside the
    former body's). Returns split_plan's row."""
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    plan, splits = split_of(serving)
    rows = []
    for pps in sorted(set(PPS_SWEEP) | {plan}):
        ctx_rows, per_page = context_sweep(full, page_size, flush, pps)
        rows.append({"pages_per_split": pps,
                     "splits": -(-serving[3].shape[1] // pps),
                     "serving_ms": time_ms(lambda: paged_decode_attention(
                         *serving, pages_per_split=pps), 50, flush,
                         hold=True),
                     "context_ms": {r["context_tokens"]: r["kernel_ms"]
                                    for r in ctx_rows},
                     "ms_per_walked_page": per_page})
    ctx_rows, per_page = context_sweep(full, page_size, flush)
    former = FORMER_PAGED[kernel]["ms_per_walked_page"]
    emit({"phase": "kernel_context_sweep", "kernel": kernel,
          "pages_per_split": plan, "splits": splits,
          "live_rows": int((full[3][:, 0] != 0).sum()), "rows": ctx_rows,
          "ms_per_walked_page": per_page,
          "former_ms_per_walked_page": former, "nvidia_smi": smi})
    emit({"phase": "kernel_split_sweep", "kernel": kernel,
          "split_plan": plan, "rows": rows, "nvidia_smi": smi})
    return {"ms_per_walked_page": per_page,
            "former_ms_per_walked_page": former}


def null_split_case(rng, B, KH, G, hd, ps, P):
    """pool_case at these shapes with every live row at the table's end
    and, at split_plan's split of pps pages, a null page inside a live
    split (row 0, entry pps + 1; with pps 1 that split is null too) and
    a whole split of null pages (row 1, entries pps .. 2 pps - 1); the
    last row is all-null."""
    from deepspeed_tpu_torch.ops.attention.paged import split_plan
    pps = split_plan(B, KH, G, hd, ps, P)
    case = pool_case(rng, B, KH, G, hd, ps, P, [P * ps - 1] * (B - 1) + [0],
                     null_rows=(B - 1,))
    tables = case[3]
    tables[0, min(pps + 1, P - 1)] = 0
    tables[1, pps:2 * pps] = 0
    return case


def kernel_phase(smi):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode_attention, paged_decode_plain)
    rng = np.random.RandomState(SEED)
    # the serving shapes: 8 slots + the scratch row (all-null), GPT-2
    # 345M heads, page 16, 64-page tables (max_seq_len 1024)
    B, KH, G, hd, ps, P = 9, 16, 1, 64, 16, 64
    pos = list(rng.randint(0, P * ps, size=B - 1)) + [0]
    serving = to_device(pool_case(rng, B, KH, G, hd, ps, P, pos,
                                  null_rows=(B - 1,)), torch.bfloat16)
    err = check_kernel("serving_shapes_bf16", serving, BF16_ATOL,
                       null_rows=(B - 1,))
    edges = [0, ps - 1, ps, ps + 1, P * ps - 1, 0]
    check_kernel("cache_position_edges_bf16",
                 to_device(pool_case(rng, 6, KH, G, hd, ps, P, edges,
                                     null_rows=(5,)), torch.bfloat16),
                 BF16_ATOL, null_rows=(5,))
    # the Llama serving shapes: 32 heads over 8 kv heads
    llama_pos = list(rng.randint(0, P * ps, size=B - 1)) + [0]
    check_kernel("llama_serving_shapes_kh8_g4_bf16",
                 to_device(pool_case(rng, B, 8, 4, hd, ps, P, llama_pos,
                                     null_rows=(B - 1,)), torch.bfloat16),
                 BF16_ATOL, null_rows=(B - 1,))
    check_kernel("gqa_kh2_g4_hd128_bf16",
                 to_device(pool_case(rng, 5, 2, 4, 128, ps, 8,
                                     [3, 16, 40, 127, 64]), torch.bfloat16),
                 BF16_ATOL)
    check_kernel("fp32_page128",
                 to_device(pool_case(rng, 4, 4, 2, 64, 128, 4,
                                     [0, 127, 128, 511], null_rows=(3,)),
                           torch.float32), FP32_ATOL, null_rows=(3,))
    check_kernel("null_page_in_live_split_and_null_split_bf16",
                 to_device(null_split_case(rng, B, KH, G, hd, ps, P),
                           torch.bfloat16), BF16_ATOL, null_rows=(B - 1,))

    # timing at the serving shapes; the pool's K/V would sit in the 50 MB
    # L2 across back-to-back calls, which a decode step (23 other layers
    # between two reads of one layer's pool) never sees: flush it
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: paged_decode_attention(*serving),
                        TIMED_CALLS, flush, hold=True)
    unheld_ms = time_ms(lambda: paged_decode_attention(*serving),
                        TIMED_CALLS, flush)
    plain_ms = time_ms(lambda: paged_decode_plain(*serving), 50, flush)
    q, kpool, vpool, tables, positions = serving
    # yardstick: one SDPA call over pre-gathered contiguous stripes
    L = P * ps
    kc = kpool[tables.long()].transpose(1, 2).reshape(B, KH, L, hd)
    vc = vpool[tables.long()].transpose(1, 2).reshape(B, KH, L, hd)
    kc = torch.nan_to_num(kc).contiguous()
    vc = torch.nan_to_num(vc).contiguous()
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
        TIMED_CALLS, flush, hold=True)
    live = [int(p) for p, t in zip(positions.tolist(), tables.tolist())
            if t[0] != 0]
    # what the kernel must move: K and V of each live row's positions
    # 0..pos (rows past pos are never loaded), the table entries of the
    # pages it walks, q in, the output out, and the positions
    walked = sum(min(int(p) // ps + 1, P) for p in positions.tolist())
    kv_bytes = sum((p + 1) * KH * hd * 2 * 2 for p in live)
    other = 2 * q.numel() * 2 + walked * 4 + positions.numel() * 4
    # q.K and P.V: 2 * hd multiply-adds per visible token per query head
    flops = sum(4 * (p + 1) * KH * G * hd for p in live)
    bytes_per_s, flops_per_s = card_peaks(smi)
    bytes_ms = (kv_bytes + other) / bytes_per_s * 1e3
    ops_ms = flops / flops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    full = [P * ps - 1] * (B - 1) + [0]
    sweep = split_sweep(
        "paged_decode", serving,
        to_device(pool_case(rng, B, KH, G, hd, ps, P, full,
                            null_rows=(B - 1,), poison=False),
                  torch.bfloat16), ps, flush, smi)
    pps, splits = split_of(serving)
    row = {"phase": "kernel_timing", "kernel": "paged_decode",
           "shape": {"B": B, "H": KH * G, "KH": KH, "hd": hd,
                     "page_size": ps, "P": P, "dtype": "bf16"},
           "positions": [int(p) for p in positions.tolist()],
           "pages_per_split": pps, "splits": splits,
           "bytes": kv_bytes + other, "flops": flops, "kernel_ms": kernel_ms,
           "kernel_ms_unheld": unheld_ms,
           "former_kernel_ms": FORMER_PAGED["paged_decode"]["kernel_ms"],
           **sweep,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "achieved_gb_per_s": (kv_bytes + other) / kernel_ms / 1e6,
           "nvidia_smi": smi}
    emit(row)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pages_per_split": pps}


def int8_pool_case(rng, batch, kv_heads, group, hd, page_size,
                   pages_per_seq, nb, positions, null_rows=(), share=None):
    """Numpy inputs of one int8 paged-decode call: float K/V quantized
    per token row into ``nb`` blocks (the port's quantize_kv), distinct
    non-null pages per row. Every token row past a row's position, in
    its last live page and in the pages after it, holds garbage payload
    under NaN scales: nothing may read it. ``share=(a, b, n)`` points
    row b's first n table entries at row a's pages (a shared prefix;
    both rows must be past those pages)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import quantize_kv
    q, kf, vf, tables, pos = pool_case(rng, batch, kv_heads, group, hd,
                                       page_size, pages_per_seq, positions,
                                       null_rows=null_rows, poison=False)
    kq, ks = (t.numpy() for t in quantize_kv(torch.from_numpy(kf), nb))
    vq, vs = (t.numpy() for t in quantize_kv(torch.from_numpy(vf), nb))
    if share is not None:
        a, b, n = share
        if min(pos[a], pos[b]) // page_size < n:
            raise ValueError("shared pages must lie before both positions")
        tables[b, :n] = tables[a, :n]
    for b in range(batch):
        if b in null_rows:
            continue
        last = int(pos[b]) // page_size
        for i in range(last, pages_per_seq):
            first_dead = int(pos[b]) % page_size + 1 if i == last else 0
            page = tables[b, i]
            for payload, scales in ((kq, ks), (vq, vs)):
                payload[page, :, first_dead:] = -128
                scales[page, :, first_dead:] = np.nan
    return q, kq, vq, ks, vs, tables, pos


def int8_to_device(case, dtype):
    """Arguments of paged_decode_attention on the card, in its order."""
    import torch
    q, kq, vq, ks, vs, tables, pos = case
    dev = lambda a: torch.from_numpy(a).cuda()
    return (dev(q).to(dtype), dev(kq), dev(vq), dev(tables), dev(pos), None,
            dev(ks), dev(vs))


def check_int8_kernel(name, args, null_rows=(), identical_rows=None):
    """The int8 kernel against its plain version on the same inputs,
    element by element (INT8_TOL). Two controls must fail the same
    check: the plain version with every scale set to 1 (the scales left
    out), and the dense arity's habits (the dequantized pools held in
    bf16 and the probabilities rounded to bf16)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.paged import (
        dequantize_pool, paged_decode_attention, paged_decode_plain)
    q, kq, vq, tables, pos, _, ks, vs = args
    out = paged_decode_attention(*args)
    torch.cuda.synchronize()
    pps, splits = split_of(args)
    ref = paged_decode_plain(*args, pages_per_split=pps)
    err_whole = float((out.float() - paged_decode_plain(*args).float()
                       ).abs().max())
    tol = INT8_TOL["fp32" if q.dtype == torch.float32 else "bf16"]
    ratio, _, err, ok = compare(out, ref, **tol)
    nulls_zero = all(bool((out[b] == 0).all()) for b in null_rows)
    same = identical_rows is None or bool(
        (out[identical_rows[0]] == out[identical_rows[1]]).all())
    controls = {
        "scales_left_out": paged_decode_plain(
            q, kq, vq, tables, pos, None, torch.ones_like(ks),
            torch.ones_like(vs), pages_per_split=pps),
        "dense_habits": paged_decode_plain(
            q, torch.nan_to_num(dequantize_pool(kq, ks)).bfloat16(),
            torch.nan_to_num(dequantize_pool(vq, vs)).bfloat16(), tables,
            pos, pages_per_split=pps),
    }
    row = {"phase": "int8_kernel_check", "case": name,
           "dtype": str(q.dtype), "shape_q": list(q.shape),
           "shape_pool": list(kq.shape), "scale_blocks": ks.shape[-1],
           "pages_per_split": pps, "splits": splits,
           "tol": tol, "max_abs_err": err, "worst_ratio": ratio,
           "max_abs_err_unsplit": err_whole, "atol_unsplit": UNSPLIT_ATOL,
           "null_rows_zero": nulls_zero, "shared_rows_identical": same}
    ok = ok and nulls_zero and same and err_whole <= UNSPLIT_ATOL
    for cname, cout in controls.items():
        c_ratio, _, _, c_ok = compare(cout, ref, **tol)
        row[f"control_{cname}_worst_ratio"] = c_ratio
        row[f"control_{cname}_fails"] = not c_ok
        ok = ok and not c_ok
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"int8 paged decode kernel disagrees with its "
                             f"plain version on {name}, or a control that "
                             f"must fail passes: {row}")
    return err


# the Llama serving shapes: 8 slots + the scratch row (all-null), 32
# heads over 8 kv heads of dim 64, page 16, 64-page tables (max_seq_len
# 1024), one scale per token row
INT8_MAIN = dict(B=9, KH=8, G=4, hd=64, ps=16, P=64, nb=1)


def int8_kernel_phase(smi):
    """Check the int8 arity against its plain version, then time it at
    the main-path shape beside its bound, its plain version and one SDPA
    call over pre-gathered, pre-dequantized stripes."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention.paged import (
        dequantize_pool, paged_decode_attention, paged_decode_plain,
        split_plan)
    rng = np.random.RandomState(SEED + 4)
    m = INT8_MAIN
    B, KH, G, hd, ps, P, nb = (m[k] for k in ("B", "KH", "G", "hd", "ps",
                                              "P", "nb"))
    pos = list(rng.randint(0, P * ps, size=B - 1)) + [0]
    main = int8_to_device(int8_pool_case(rng, B, KH, G, hd, ps, P, nb, pos,
                                         null_rows=(B - 1,)), torch.bfloat16)
    err = check_int8_kernel("llama_serving_shapes_bf16", main,
                            null_rows=(B - 1,))
    # the GPT-2 345M serving shapes: 16 heads, each its own kv head
    gpt2_pos = list(rng.randint(0, P * ps, size=B - 1)) + [0]
    check_int8_kernel(
        "gpt2_serving_shapes_kh16_g1_bf16",
        int8_to_device(int8_pool_case(rng, B, 16, 1, hd, ps, P, nb, gpt2_pos,
                                      null_rows=(B - 1,)), torch.bfloat16),
        null_rows=(B - 1,))
    edges = [0, ps - 1, ps, ps + 1, P * ps - 1, P * ps + 40, 0]
    check_int8_kernel(
        "cache_position_edges_past_table_fp32",
        int8_to_device(int8_pool_case(rng, 7, KH, G, hd, ps, P, nb, edges,
                                      null_rows=(6,)), torch.float32),
        null_rows=(6,))
    check_int8_kernel(
        "g1_hd128_nb2_page8_fp32",
        int8_to_device(int8_pool_case(rng, 5, 4, 1, 128, 8, 16, 2,
                                      [3, 8, 40, 127, 64]), torch.float32))
    check_int8_kernel(
        "g1_hd128_nb4_page8_fp32",
        int8_to_device(int8_pool_case(rng, 4, 2, 1, 128, 8, 8, 4,
                                      [0, 7, 8, 63], null_rows=(0,)),
                       torch.float32),
        null_rows=(0,))
    check_int8_kernel(
        "g4_hd128_nb4_bf16",
        int8_to_device(int8_pool_case(rng, 5, 2, 4, 128, ps, 8, 4,
                                      [3, 16, 40, 127, 64], null_rows=(1,)),
                       torch.bfloat16),
        null_rows=(1,))
    # rows 0 and 1 share their first two pages and carry the same query
    # at the same position, with the same tail page contents
    shared = int8_pool_case(rng, 3, KH, G, hd, ps, 4, nb, [40, 40, 9],
                            share=(0, 1, 2))
    shared[0][1] = shared[0][0]
    shared[5][1, 2] = shared[5][0, 2]
    check_int8_kernel("shared_prefix_pages_fp32",
                      int8_to_device(shared, torch.float32),
                      identical_rows=(0, 1))
    # a null page inside a live split (row 0) and a whole split of null
    # pages (row 1) at split_plan's split of the Llama serving shapes
    nulls = int8_pool_case(rng, B, KH, G, hd, ps, P, nb,
                           [P * ps - 1] * (B - 1) + [0], null_rows=(B - 1,))
    plan = split_plan(B, KH, G, hd, ps, P)
    nulls[5][0, min(plan + 1, P - 1)] = 0
    nulls[5][1, plan:2 * plan] = 0
    check_int8_kernel("null_page_in_live_split_and_null_split_bf16",
                      int8_to_device(nulls, torch.bfloat16),
                      null_rows=(B - 1,))

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_ms = time_ms(lambda: paged_decode_attention(*main), TIMED_CALLS,
                        flush, hold=True)
    unheld_ms = time_ms(lambda: paged_decode_attention(*main), TIMED_CALLS,
                        flush)
    plain_ms = time_ms(lambda: paged_decode_plain(*main), 50, flush)
    q, kq, vq, tables, positions, _, ks, vs = main
    # yardstick: one SDPA call over stripes gathered, dequantized to bf16
    # and expanded to the 32 q heads beforehand, so it leaves the
    # dequantization (and the gather) out
    L = P * ps
    stripe = lambda pool, sc: torch.nan_to_num(
        dequantize_pool(pool[tables.long()], sc[tables.long()])
    ).transpose(1, 2).reshape(B, KH, L, hd).repeat_interleave(
        G, dim=1).bfloat16().contiguous()
    kc, vc = stripe(kq, ks), stripe(vq, vs)
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask),
        TIMED_CALLS, flush, hold=True)
    live = [int(p) for p, t in zip(positions.tolist(), tables.tolist())
            if t[0] != 0]
    # what the kernel must move: the int8 K and V of each live row's
    # positions 0..pos and their scale rows, the table entries of the
    # pages it walks, q in, the output out, and the positions
    walked = sum(min(int(p) // ps + 1, P) for p in positions.tolist())
    kv_bytes = sum((p + 1) * KH * (hd + nb * 4) * 2 for p in live)
    other = 2 * q.numel() * 2 + walked * 4 + positions.numel() * 4
    # q.K and P.V (2 * hd multiply-adds per visible token per query head)
    # and one dequantizing multiply per K and V value, all in fp32
    flops = sum((p + 1) * KH * (4 * G * hd + 2 * hd) for p in live)
    bytes_per_s, flops_per_s = card_peaks(smi, "fp32")
    bytes_ms = (kv_bytes + other) / bytes_per_s * 1e3
    ops_ms = flops / flops_per_s * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    full = [P * ps - 1] * (B - 1) + [0]
    sweep = split_sweep(
        "paged_decode_int8", main,
        int8_to_device(int8_pool_case(rng, B, KH, G, hd, ps, P, nb, full,
                                      null_rows=(B - 1,)), torch.bfloat16),
        ps, flush, smi)
    pps, splits = split_of(main)
    emit({"phase": "int8_kernel_timing", "kernel": "paged_decode_int8",
          "shape": dict(m, H=KH * G, dtype_q="bf16"),
          "positions": [int(p) for p in positions.tolist()],
          "pages_per_split": pps, "splits": splits,
          "bytes": kv_bytes + other, "flops": flops, "kernel_ms": kernel_ms,
          "kernel_ms_unheld": unheld_ms,
          "former_kernel_ms": FORMER_PAGED["paged_decode_int8"]["kernel_ms"],
          **sweep,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "scaled_dot_product_attention over pre-gathered, "
                     "pre-dequantized bf16 stripes expanded to 32 heads: "
                     "it leaves the dequantization out",
          "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
          "ops_peak": "fp32 outside the tensor cores",
          "bound_ms": bound_ms, "bound_by": bound_by,
          "achieved_gb_per_s": (kv_bytes + other) / kernel_ms / 1e6,
          "nvidia_smi": smi})
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pages_per_split": pps}


# ------------------------------------------------------------- serving
def make_prompts(vocab):
    """16 prompts of 20-250 tokens; 8 share one 64-token prefix. The
    lengths are chosen so that admission groups them into batches of
    both prompt buckets and of both batch buckets (serving_phase checks
    that every bucket was served)."""
    rng = np.random.RandomState(SEED)
    prefix = rng.randint(0, vocab, size=SHARED_PREFIX).tolist()
    lengths = [20, 250, 33, 90, 47, 110, 61, 130,
               76, 150, 170, 190, 205, 220, 235, 240]
    shared = {3, 5, 7, 8, 10, 12, 14, 15}
    prompts = []
    for i, n in enumerate(lengths):
        if i in shared:
            prompts.append(prefix + rng.randint(
                0, vocab, size=n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.randint(0, vocab, size=n).tolist())
    return prompts


def serve(engine, prompts, new_tokens, after_warmup=None):
    """Warm up (the program set captured as CUDA graphs), call
    ``after_warmup(engine)`` if given, serve ``prompts`` greedily until
    idle; return the finished requests by submission order and the main
    path's counts: the paged-decode launches, each program kind's
    dispatches and seconds (``<kind>_dispatches``, ``<kind>_secs``), the
    wall time, the warm program count and ``steady_state_recompiles``
    after the run."""
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    warm = engine.warmup()
    if after_warmup is not None:
        after_warmup(engine)
    disp0, secs0 = dict(engine.dispatches), dict(engine.dispatch_secs)
    uids = [engine.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                  temperature=0.0, seed=i))
            for i, p in enumerate(prompts)]
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_int8 = 0
    t0 = time.perf_counter()
    done = {f.uid: f for f in engine.run()}
    wall = time.perf_counter() - t0
    counts = {"launches": paged_decode_attention.launches,
              "launches_int8": paged_decode_attention.launches_int8,
              "wall_secs": wall, "programs_warm": warm,
              "steady_state_recompiles": engine.steady_state_recompiles}
    for name in engine.dispatches:
        counts[f"{name}_dispatches"] = engine.dispatches[name] - disp0[name]
        counts[f"{name}_secs"] = engine.dispatch_secs[name] - secs0[name]
    return [done[u] for u in uids], counts


def program_rows(engine):
    """The engine's program set as printed: per program its dispatches,
    replays, whether a CUDA graph holds it and the paged-decode launches
    a replay adds; and ``steady_state_recompiles``."""
    state = engine.debug_state()
    return {"programs": state["program_set"],
            "steady_state_recompiles": state["steady_state_recompiles"]}


def check_graphs(phase, engine):
    """Fail unless none of the engine's programs was built after warmup
    and, on the card, a CUDA graph holds every one (on the CPU, where a
    phase is rehearsed, they run eagerly)."""
    rows = program_rows(engine)
    eager = [k for k, p in rows["programs"].items() if not p["graph"]] \
        if engine.device.type == "cuda" else []
    if rows["steady_state_recompiles"] != 0 or eager:
        raise AssertionError(f"{phase}: steady_state_recompiles "
                             f"{rows['steady_state_recompiles']}, programs "
                             f"without a graph {eager}")
    return rows


def serving_phase(model_config, params, device, smi, model="gpt2-345m",
                  inference_config=None, requests=None):
    """Serve the 16 requests of make_prompts (or only the first
    ``requests`` of them) through InferenceEngine and check the outputs
    and that the pool's kernel, and only it, ran once per layer per
    decode dispatch. Returns (the kernel's launches, prompts, engine,
    generated tokens)."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model_config, params, inference_config or {},
                             dtype=torch.bfloat16, device=device)
    prompts = make_prompts(model_config.vocab_size)[:requests]
    finished, counts = serve(engine, prompts, NEW_TOKENS)
    for p, f in zip(prompts, finished):
        if f.finish_reason != "length" or len(f.tokens) != NEW_TOKENS or \
                len(f.prompt + f.tokens) != len(p) + NEW_TOKENS:
            raise AssertionError(f"request {f.uid}: {f.finish_reason}, "
                                 f"{len(f.tokens)} tokens")
        if not all(0 <= t < model_config.vocab_size for t in f.tokens):
            raise AssertionError(f"request {f.uid}: token outside vocab")
    layers = model_config.num_layers
    quantized = engine.paged_spec.quantized
    ran, other = (("launches_int8", "launches") if quantized
                  else ("launches", "launches_int8"))
    if counts[ran] <= 0 or counts[other] != 0 or \
            counts[ran] != counts["decode_dispatches"] * layers:
        raise AssertionError(
            f"paged decode kernel {ran} {counts[ran]} != decode dispatches "
            f"{counts['decode_dispatches']} x {layers} layers, or the other "
            f"arity's kernel ran ({other} {counts[other]})")
    graphs = check_graphs("serving", engine)
    state = engine.debug_state()
    shapes = state["prefill_shapes"]
    hits = state["page_pool"]["prefix_cache"]["hit_requests"]
    if requests is None:        # the full traffic reaches every bucket
        buckets = {s.split("x")[i] for s in shapes for i in (0, 1)}
        want = {str(b) for b in engine.config["batch_buckets"]
                + engine.config["prompt_buckets"]}
        if not want <= buckets:
            raise AssertionError(f"served prefill shapes {shapes} miss a "
                                 f"bucket of {sorted(want)}")
        if hits < 1:
            raise AssertionError("the shared prefix never hit the prefix "
                                 "cache")
    ttft = [f.ttft_ms for f in finished]
    decode_tokens = sum(len(f.tokens) - 1 for f in finished)
    quant = state["quantization"]
    emit({"phase": "serving_tokens", "model": model,
          "kv_dtype": quant["kv_dtype"],
          "tokens": [f.tokens for f in finished]})
    row = {"phase": "serving", "model": model, "dtype": "bf16",
           "family": state["family"], "kv_dtype": quant["kv_dtype"],
           "kv_pool_bytes_per_token": quant["kv_pool_bytes_per_token"],
           "requests": len(finished), "new_tokens": NEW_TOKENS,
           "prompt_lengths": [len(p) for p in prompts],
           "prefill_shapes": shapes, "prefix_hit_requests": hits,
           "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / counts["decode_secs"],
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           "decode_step_ms_mean": (counts["decode_secs"] * 1e3
                                   / counts["decode_dispatches"]),
           "prefill_secs": counts["prefill_secs"],
           "wall_secs": counts["wall_secs"],
           "decode_dispatches": counts["decode_dispatches"],
           "kernel": "paged_decode_int8" if quantized else "paged_decode",
           "kernel_launches": counts[ran],
           "other_arity_launches": counts[other],
           "programs_warm": counts["programs_warm"], **graphs,
           "nvidia_smi": smi}
    if on_cuda:
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(row)
    return counts[ran], prompts, engine, [f.tokens for f in finished]


def device_kernels(run, steps, cpu=False):
    """A torch.profiler window over ``run()`` (``steps`` steps) and a
    synchronise, after one before it: each device kernel's (name, ms per
    step, launches per step), the longest first, user annotation ranges
    left out. CUDA activity alone unless ``cpu``: the profile phases read
    the kernels' device time only, and CPU events take about 4x as long
    to process (:func:`profile_activity_probe` holds the two against each
    other)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count / steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    return kernels


def profile_phase(engine, prompts, steps=8, model="gpt2-345m"):
    """Where a decode step's time goes, with 8 requests in flight: the
    wall time of ``steps`` decode-only steps (host clock, synchronised),
    then a torch.profiler window over ``steps`` more for the kernels'
    own device time (one stream, so kernels do not overlap; user
    annotation ranges are left out). The device idle share is what the
    kernels leave of the unprofiled wall time."""
    import torch
    from deepspeed_tpu_torch.inference import Request
    for i, p in enumerate(prompts[:8]):
        engine.submit(Request(prompt=p, max_new_tokens=2 * steps + 4,
                              seed=i))
    engine.step()                       # prefill + one decode
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(lambda: [engine.step() for _ in range(steps)],
                             steps)
    engine.run()                        # drain what is left
    graphs = check_graphs("decode_profile", engine)
    busy_ms = sum(k[1] for k in kernels)
    emit({"phase": "decode_profile", "model": model, **graphs,
          "kv_dtype": engine.debug_state()["quantization"]["kv_dtype"],
          "steps": steps, "rows": 8,
          "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1 - busy_ms / wall_ms,
          "paged_decode_ms_per_step": sum(
              k[1] for k in kernels if "paged_decode" in k[0]),
          "kernel_launches_per_step": sum(k[2] for k in kernels),
          "top_kernels": [{"name": k[0][:80], "ms_per_step": k[1],
                           "calls_per_step": k[2]} for k in kernels[:10]]})


def model_path_phase(model_config, params, device, prompts, forward,
                     model="gpt2-345m", inference_config=None,
                     decode_steps=1):
    """``decode_steps`` decode steps from one prefilled state, through
    the whole fp32 model with the paged-decode kernel and with the plain
    gather attention, each on its own copy of the pools and both fed the
    kernel path's greedy tokens. Logits are compared at every step; over
    an int8 pool the pools are compared too: the first layer's payload
    and scales hold the same bits (the write path does not depend on the
    attention), and past it the two paths' differently ordered sums may
    move a value across an int8 rounding step."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference import Request
    engine = InferenceEngine(model_config, params, inference_config or {},
                             dtype=torch.float32, device=device)
    engine.warmup()
    for i, p in enumerate(prompts[:8]):
        engine.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS, seed=i))
    engine.step()                       # prefill + one decode
    sched = engine.scheduler
    sids, toks, poss, _, _ = sched.decode_state()
    rows = engine.num_slots + 1
    tok_a = np.zeros((rows, 1), np.int32)
    pos_a = np.zeros((rows,), np.int32)
    tok_a[sids, 0] = toks
    pos_a[sids] = poss
    tables = sched.block_table_rows(rows, engine.paged_spec.pages_per_seq)
    dev = engine.device
    caches = {path: tuple(c.clone() for c in engine._cache)
              for path in ("kernel", "gather")}
    err, match = 0.0, 1.0
    for step in range(decode_steps):
        logits = {}
        for path, cache in caches.items():
            out, _ = forward(
                engine.params, model_config,
                torch.as_tensor(tok_a, device=dev), dtype=torch.float32,
                kv_cache=cache,
                cache_position=torch.as_tensor(pos_a + step, device=dev),
                block_tables=torch.as_tensor(tables, device=dev),
                paged_attn_kernel=path)
            logits[path] = out[sids, 0]
        err = max(err, float((logits["kernel"]
                              - logits["gather"]).abs().max()))
        nxt = logits["kernel"].argmax(-1)
        match = min(match, float((nxt == logits["gather"].argmax(-1))
                                 .float().mean()))
        tok_a[sids, 0] = nxt.cpu().numpy()
    row = {"phase": "model_kernel_vs_plain", "model": model,
           "layers": model_config.num_layers, "dtype": "fp32",
           "kv_dtype": engine.debug_state()["quantization"]["kv_dtype"],
           "rows": len(sids), "decode_steps": decode_steps,
           "max_abs_logit_err": err, "atol": MODEL_LOGIT_ATOL,
           "argmax_match_share": match,
           **check_graphs("model_kernel_vs_plain", engine)}
    ok = err <= MODEL_LOGIT_ATOL
    if engine.paged_spec.quantized:
        (kk, vk, ksk, vsk), (kg, vg, ksg, vsg) = (caches["kernel"],
                                                  caches["gather"])
        # page 0 is scratch: pad rows and idle slots write there
        first_equal = all(bool((a[0, 1:] == b[0, 1:]).all()) for a, b in
                          ((kk, kg), (vk, vg), (ksk, ksg), (vsk, vsg)))
        diff = [(a[:, 1:].int() - b[:, 1:].int()).abs()
                for a, b in ((kk, kg), (vk, vg))]
        flips = sum(int((d != 0).sum()) for d in diff)
        worst = max(int(d.max()) for d in diff)
        scale_rel = max(float(((a[:, 1:] - b[:, 1:]).abs()
                               / b[:, 1:].abs().clamp_min(1e-30)).max())
                        for a, b in ((ksk, ksg), (vsk, vsg)))
        # K and V values of every token the rows hold by now, all layers
        written = int((pos_a[sids] + decode_steps).sum()) * 2 * \
            kk.shape[0] * kk.shape[2] * kk.shape[4]
        row.update(first_layer_pools_bitwise_equal=first_equal,
                   payload_values_written=written,
                   payload_values_differing=flips,
                   payload_worst_step=worst,
                   payload_flip_share_limit=INT8_POOL_FLIP_SHARE,
                   scale_max_rel_diff=scale_rel,
                   scale_rtol=INT8_POOL_SCALE_RTOL)
        ok = ok and first_equal and worst <= 1 and \
            scale_rel <= INT8_POOL_SCALE_RTOL and \
            flips <= INT8_POOL_FLIP_SHARE * written
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"the kernel path differs from the plain "
                             f"path: {row}")


def record_samples(engine, keep=()):
    """Wrap the engine's sampler: the gap between the top two logits of
    every sampled row, by (request seed, position of the sampled token),
    and the fp32 logits of the rows whose key is in ``keep``. ``serve``
    seeds request i with i and samples its j-th token at position
    len(prompt) + j; pad rows sit at positions below every prompt's."""
    import torch
    gaps, kept = {}, {}
    sample = engine._sample_tokens

    def rec(logits, seeds, sample_pos, temps):
        top = torch.topk(logits.float(), 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu().numpy()
        for i, key in enumerate(zip(seeds.tolist(), sample_pos.tolist())):
            gaps[key] = float(gap[i])
            if key in keep:
                kept[key] = logits[i].float().cpu()
        return sample(logits, seeds, sample_pos, temps)
    engine._sample_tokens = rec
    return gaps, kept


def divergences(ref, got, prompts, gaps):
    """Per request whose greedy tokens differ from ``ref``'s: the first
    diverging index, its position and the reference run's top-two gap
    there (``gaps`` of :func:`record_samples`)."""
    rows = []
    for i, (a, b, p) in enumerate(zip(ref, got, prompts)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        rows.append({"request": i, "index": j, "position": len(p) + j,
                     "gap": gaps.get((i, len(p) + j))})
    return rows, all(r["gap"] is not None and r["gap"] < TIE_GAP
                     for r in rows)


def _live_cases(engine, prompts):
    """Realistic dispatches of every program kind on a serving engine:
    ((key, host arrays, rows compared), ...). Two requests prefill and
    decode once; then a decode at each table width and a verify at each
    width over their state, a prefill of a third request and the first
    chunk of a fourth past the largest prompt bucket."""
    from deepspeed_tpu_torch.inference import Request
    sched, rows = engine.scheduler, engine._rows
    pps = engine.paged_spec.pages_per_seq
    for i, p in enumerate(prompts[:2]):
        engine.submit(Request(prompt=p, max_new_tokens=8, seed=i))
    engine.step()
    sids, toks, poss, _, _ = sched.decode_state()
    t = np.zeros((rows,), np.int32)
    pos = np.zeros((rows,), np.int32)
    t[sids], pos[sids] = toks, poss
    cases = []
    for w in engine._decode_page_buckets:
        cases.append((("decode", w), {"toks": t, "positions": pos,
                                      "tables": sched.block_table_rows(
                                          rows, w)}, list(sids)))
    for v in engine._verify_widths:
        vt = np.zeros((rows, v), np.int32)
        vt[:, 0] = t
        vt[sids, 1:] = np.asarray(toks)[:, None]
        cases.append((("verify", v), {
            "toks": vt, "positions": pos,
            "tables": sched.block_table_rows(rows, pps)},
            [s * v + j for s in sids for j in range(v)]))
    engine.submit(Request(prompt=prompts[2], max_new_tokens=8, seed=2))
    (batch,) = sched.admit()
    bb, sb = batch.batch_bucket, batch.prompt_bucket
    host, _, _ = engine._prefill_host(bb, sb)
    pl, pages = batch.prefix_lens[0], batch.page_tables[0]
    suffix = prompts[2][pl:]
    host["ids"][0, :len(suffix)] = suffix
    host["lengths"][0] = len(suffix)
    host["positions"][0] = pl
    host["tables"][0, :len(pages)] = pages
    cases.append((engine._program("prefill", bb, sb)[0], host, [0]))
    rng = np.random.RandomState(SEED + 7)
    long = rng.randint(0, engine.model_config.vocab_size,
                       size=max(engine.config["prompt_buckets"]) + 100)
    engine.submit(Request(prompt=long.tolist(), max_new_tokens=8, seed=3))
    if sched.admit():
        raise AssertionError("the long prompt was not admitted to chunk")
    (sid,) = sched.chunk_batch(cap=1)
    start, n = sched.chunk_span(sid)
    ct = engine._chunk_tokens
    host, _, _ = engine._prefill_host(1, ct)
    host["ids"][0, :n] = long[start:start + n]
    host["lengths"][0] = n
    host["positions"][0] = start
    slot_pages = sched.slots[sid].pages
    host["tables"][0, :len(slot_pages)] = slot_pages
    cases.append((engine._program("chunk", 1, ct)[0], host, [0]))
    return cases


def graph_vs_eager_phase(smi, model_config, params, model, kv_dtype=None,
                         device="cuda"):
    """43. Each program kind (prefill, decode at each table width, verify,
    chunk) of a bf16 engine at full width, on live serving state: one
    dispatch replayed from its CUDA graph, then the same program run
    eagerly from a copy of the pool as it was before. The live rows'
    logits and the pool past the null page (pad rows write there, in no
    fixed order) must be bitwise equal, and the paged-decode launches
    counted through the replay must equal the eager run's."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference.programs import key_name
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention as k4
    pk = {"decode_page_buckets": [16, 32]}
    if kv_dtype:
        pk["kv_dtype"] = kv_dtype
    icfg = dict(SPEC_DECODE, paged_kv=pk,
                chunked_prefill={"enabled": True, "chunk_tokens": 128})
    engine = InferenceEngine(model_config, params, icfg,
                             dtype=torch.bfloat16, device=device)
    warm = engine.warmup()
    cases = _live_cases(engine, make_prompts(model_config.vocab_size)[1:])
    rows, ok = [], True
    for key, host, live in cases:
        prog = engine.programs.programs[key]
        pool0 = [c.clone() for c in engine._cache]
        before = (k4.launches, k4.launches_int8)
        got = engine.programs.dispatch(key, prog.body, host).clone()
        graph_k4 = (k4.launches - before[0], k4.launches_int8 - before[1])
        pool_g = [c.clone() for c in engine._cache]
        for c, c0 in zip(engine._cache, pool0):
            c.copy_(c0)
        before = (k4.launches, k4.launches_int8)
        want = engine.programs.run_eager(key, host)
        eager_k4 = (k4.launches - before[0], k4.launches_int8 - before[1])
        logits_equal = bool(torch.equal(got[live], want[live]))
        pool_equal = all(bool(torch.equal(a[:, 1:], b[:, 1:]))
                         for a, b in zip(pool_g, engine._cache))
        want_k4 = model_config.num_layers if key[0] == "decode" else 0
        row = {"program": key_name(key), "rows": len(live),
               "logits_bitwise": logits_equal, "pool_bitwise": pool_equal,
               "logits_max_abs_diff": float((got[live].float()
                                             - want[live].float())
                                            .abs().max()),
               "k4_launches_replay": sum(graph_k4),
               "k4_launches_eager": sum(eager_k4),
               "replays": prog.replays}
        rows.append(row)
        ok = ok and logits_equal and pool_equal and \
            graph_k4 == eager_k4 and sum(graph_k4) == want_k4
        del pool0, pool_g
    kinds = {r["program"].split("/")[0] for r in rows}
    ok = ok and kinds == {"prefill", "decode", "verify", "chunk"} and \
        engine.steady_state_recompiles == 0
    emit({"phase": "graph_vs_eager", "model": model, "dtype": "bf16",
          "kv_dtype": engine.debug_state()["quantization"]["kv_dtype"],
          "programs_warm": warm, "cases": rows,
          "steady_state_recompiles": engine.steady_state_recompiles,
          "ok": ok, "nvidia_smi": smi})
    if not ok:
        raise AssertionError(f"graph_vs_eager {model}: a replay differs "
                             f"from its eager run: {rows}")
    del engine


def last_row(phase, **match):
    """The last row emitted for ``phase`` whose fields hold ``match``."""
    for row in reversed(ROWS):
        if row.get("phase") == phase and all(row.get(k) == v
                                             for k, v in match.items()):
            return row
    return None


def _serving_numbers(finished, counts, kinds=("decode", "verify")):
    ttft = [f.ttft_ms for f in finished]
    tokens = sum(len(f.tokens) - 1 for f in finished)
    secs = sum(counts.get(f"{k}_secs", 0.0) for k in kinds)
    return {"decode_tokens": tokens, "decode_tokens_per_s": tokens / secs,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p95": float(np.percentile(ttft, 95))}


def spec_decode_serving_phase(smi, model_config, params, model,
                              plain_tokens, ref=None, device="cuda"):
    """44. Speculative decoding (n-gram drafter, k 4) on the 16 requests
    of phase 3. In fp32 (as phase 4 runs), greedy tokens with it equal
    those without it, but at a near-tie (TIE_GAP; each divergence row
    names its position and the spec-off run's gap). In bf16, the
    acceptance rate, proposed and accepted drafts, verify and decode
    dispatches, decode tokens/s and TTFT beside the spec-off serving
    row, and the share of tokens equal to it; fails on zero accepted
    drafts. The paged-decode kernel runs once per layer per plain decode
    dispatch (verify dispatches run the gather attention). ``ref`` is
    the plain fp32 run of :func:`fp32_reference` (None: no fp32 check).
    Returns the kernel's launches of the bf16 run."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    prompts = make_prompts(model_config.vocab_size)
    layers = model_config.num_layers
    if ref is not None:
        ref_tokens, gaps = ref
        engine = InferenceEngine(model_config, params, SPEC_DECODE,
                                 dtype=torch.float32, device=device)
        got, counts = serve(engine, prompts, NEW_TOKENS)
        div, ok = divergences(ref_tokens, [f.tokens for f in got], prompts,
                              gaps)
        row = {"phase": "spec_decode_fp32", "model": model, "dtype": "fp32",
               "requests": len(prompts), "new_tokens": NEW_TOKENS,
               "greedy_equal_requests": len(prompts) - len(div),
               "divergences": div, "tie_gap": TIE_GAP,
               "verify_dispatches": counts["verify_dispatches"],
               "decode_dispatches": counts["decode_dispatches"],
               "accepted": sum(f.draft_accepted for f in got),
               "proposed": sum(f.draft_proposed for f in got),
               **check_graphs("spec_decode_fp32", engine), "ok": ok,
               "nvidia_smi": smi}
        emit(row)
        del engine
        if not ok:
            raise AssertionError(f"spec_decode fp32 {model}: greedy tokens "
                                 f"diverge away from a near-tie: {div}")
    engine = InferenceEngine(model_config, params, SPEC_DECODE,
                             dtype=torch.bfloat16, device=device)
    got, counts = serve(engine, prompts, NEW_TOKENS)
    graphs = check_graphs("spec_decode_serving", engine)
    proposed = sum(f.draft_proposed for f in got)
    accepted = sum(f.draft_accepted for f in got)
    pairs = [(a, b) for f, ref in zip(got, plain_tokens)
             for a, b in zip(f.tokens, ref)]
    plain = last_row("serving", model=model, kv_dtype="bfloat16") or {}
    row = {"phase": "spec_decode_serving", "model": model, "dtype": "bf16",
           "kv_dtype": "bfloat16", "requests": len(prompts),
           "new_tokens": NEW_TOKENS, "k": 4,
           "proposed": proposed, "accepted": accepted,
           "accept_rate": accepted / proposed if proposed else None,
           "verify_dispatches": counts["verify_dispatches"],
           "decode_dispatches": counts["decode_dispatches"],
           **_serving_numbers(got, counts),
           "token_share_equal_spec_off": float(np.mean([a == b for a, b
                                                        in pairs])),
           "spec_off": {k: plain.get(k) for k in (
               "decode_dispatches", "decode_tokens_per_s", "ttft_ms_p50",
               "ttft_ms_p95", "decode_step_ms_mean")},
           "kernel_launches": counts["launches"],
           "programs_warm": counts["programs_warm"], **graphs,
           "nvidia_smi": smi}
    emit(row)
    if accepted == 0 or counts["launches"] != \
            counts["decode_dispatches"] * layers or counts["launches_int8"]:
        raise AssertionError(
            f"spec_decode_serving {model}: {accepted} drafts accepted, or "
            f"K4 launched {counts['launches']} times (int8 "
            f"{counts['launches_int8']}) for {counts['decode_dispatches']} "
            f"plain decode dispatches x {layers} layers")
    del engine
    return counts["launches"]


def chunked_prefill_serving_phase(smi, model_config, params,
                                  model="gpt2-345m", device="cuda"):
    """45. Chunked prefill (256-token chunks, max_seq_len 1024) in fp32 on
    8 prompts of 600-900 tokens, past the largest default prompt bucket:
    only chunking serves them. Each first token and its logits (within
    MODEL_LOGIT_ATOL) equal those of an unchunked engine whose prompt
    buckets reach 1024; tokens may differ only at a near-tie (TIE_GAP),
    checked at each request's first divergence. Then the same with
    speculative decoding on. Prints the chunk dispatches and TTFT."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(0, model_config.vocab_size, size=n).tolist()
               for n in CHUNK_LENGTHS]
    firsts = {(i, len(p)) for i, p in enumerate(prompts)}
    ref_engine = InferenceEngine(model_config, params,
                                 {"prompt_buckets": [64, 256, 1024]},
                                 dtype=torch.float32, device=device)
    gaps, ref_first = record_samples(ref_engine, keep=firsts)
    ref, ref_counts = serve(ref_engine, prompts, CHUNK_NEW_TOKENS)
    ref_numbers = _serving_numbers(ref, ref_counts, ("decode",))
    del ref_engine
    for label, extra in (("chunked", CHUNKED),
                         ("chunked+spec", dict(CHUNKED, **SPEC_DECODE))):
        engine = InferenceEngine(model_config, params, extra,
                                 dtype=torch.float32, device=device)
        _, first = record_samples(engine, keep=firsts)
        got, counts = serve(engine, prompts, CHUNK_NEW_TOKENS)
        err = max(float((first[k] - ref_first[k]).abs().max())
                  for k in firsts)
        first_equal = [f.tokens[0] == r.tokens[0] for f, r in zip(got, ref)]
        div, tie_ok = divergences([f.tokens for f in ref],
                                  [f.tokens for f in got], prompts, gaps)
        ok = err <= MODEL_LOGIT_ATOL and tie_ok and \
            len(first) == len(firsts) and counts["chunk_dispatches"] > 0
        row = {"phase": "chunked_prefill_serving", "model": model,
               "variant": label, "dtype": "fp32", "chunk_tokens": 256,
               "prompt_lengths": list(CHUNK_LENGTHS),
               "new_tokens": CHUNK_NEW_TOKENS,
               "first_tokens_equal": sum(first_equal),
               "first_logits_max_abs_diff": err, "atol": MODEL_LOGIT_ATOL,
               "greedy_equal_requests": len(prompts) - len(div),
               "divergences": div, "tie_gap": TIE_GAP,
               "chunk_dispatches": counts["chunk_dispatches"],
               "chunk_secs": counts["chunk_secs"],
               "decode_dispatches": counts["decode_dispatches"],
               "verify_dispatches": counts.get("verify_dispatches", 0),
               **_serving_numbers(got, counts),
               "unchunked": ref_numbers,
               **check_graphs("chunked_prefill_serving", engine),
               "ok": ok, "nvidia_smi": smi}
        emit(row)
        del engine
        if not ok:
            raise AssertionError(f"chunked_prefill_serving {label}: {row}")


DISAGG = {"disagg": {"enabled": True}}
SEPARATE = {"disagg": {"enabled": True, "separate_pools": True}}
DISAGG_VARIANTS = (("shared_pool", DISAGG), ("separate_pools", SEPARATE),
                   ("separate_pools+spec", dict(SEPARATE, **SPEC_DECODE)))
INT8_WEIGHTS = {"quantize_weights": "int8"}
DENSE_CACHE = {"paged_kv": {"enabled": False}}
# generate: prompts of GEN_PROMPT tokens, GEN_BATCH of them, greedy
GEN_BATCH = 8
GEN_PROMPT = 128
GEN_NEW = 64


def _check_k4(phase, counts, layers, int8=False):
    """K4 (or K4q over an int8 pool), and only it, ran once per layer per
    plain decode dispatch."""
    ran, other = (("launches_int8", "launches") if int8
                  else ("launches", "launches_int8"))
    if counts[ran] <= 0 or counts[other] or \
            counts[ran] != counts["decode_dispatches"] * layers:
        raise AssertionError(
            f"{phase}: {ran} {counts[ran]} for "
            f"{counts['decode_dispatches']} decode dispatches x {layers} "
            f"layers, {other} {counts[other]}")
    return counts[ran]


def fp32_reference(model_config, params, prompts, device="cuda"):
    """The plain (paged, not disaggregated) engine in fp32 on
    ``prompts``: (its greedy tokens, the top-two gap of every sampled
    row), the reference phases 44, 46 and 48 hold their fp32 runs to."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    engine = InferenceEngine(model_config, params, {}, dtype=torch.float32,
                             device=device)
    gaps, _ = record_samples(engine)
    ref, _ = serve(engine, prompts, NEW_TOKENS)
    del engine
    return [f.tokens for f in ref], gaps


def _record_handoffs(engine):
    """The queue plus transfer ms of every handoff the engine claims from
    here on (a list filled as they are claimed)."""
    out = []
    record = engine._handoff_stats.record

    def rec(queue_ms, transfer_ms, pages, nbytes):
        out.append(queue_ms + transfer_ms)
        record(queue_ms, transfer_ms, pages, nbytes)
    engine._handoff_stats.record = rec
    return out


def disagg_serving_phase(smi, model_config, params, ref, model="gpt2-345m",
                         device="cuda"):
    """46. Phase 3's 16 requests under ``disagg``: over the shared pool,
    over separate pools (a migration per request through the
    handoff_export and handoff_import programs), and over separate pools
    with speculation. In fp32 the tokens equal the plain engine's
    (``ref`` of :func:`fp32_reference`) but at a near-tie (TIE_GAP), every
    handoff is claimed, a migration moves only the live prompt pages,
    the dispatch trace puts no decode behind a prefill and both pools
    drain exactly. In bf16 the TTFT p50/p95 with its handoff part, the
    handoff queue and transfer ms, the bytes moved, decode tokens/s and
    K4's launches, beside phase 3's row. Returns K4's launches of the
    bf16 runs."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference.kv_cache import pages_for
    prompts = make_prompts(model_config.vocab_size)
    layers = model_config.num_layers
    ref_tokens, gaps = ref
    live_pages = None
    launches = 0
    plain = last_row("serving", model=model, kv_dtype="bfloat16") or {}
    for label, icfg in DISAGG_VARIANTS:
        spec = "spec_decode" in icfg
        rows = {}
        for dtype in (torch.float32, torch.bfloat16):
            engine = InferenceEngine(model_config, params, icfg, dtype=dtype,
                                     device=device)
            handoff_ms = _record_handoffs(engine)
            got, counts = serve(engine, prompts, NEW_TOKENS)
            st = engine.debug_state()
            dg = st["disagg"]
            ps = engine.paged_spec.page_size
            live_pages = sum(pages_for(len(p), ps) for p in prompts)
            moved = dg["handoff"]["pages_moved"]
            checks = {
                "claimed": dg["queue"]["handoffs"] == len(prompts)
                and dg["queue"]["depth"] == 0
                and dg["queue"]["dropped"] == 0,
                "live_pages_only": moved == (
                    live_pages if engine._separate_pools else 0),
                "decode_first": dg["decode_first_fraction"] == 1.0,
                "pools_drained": st["page_pool"]["pages_in_use"] == 0
                and (not engine._separate_pools
                     or dg["prefill_pool"]["pages_in_use"] == 0)}
            if dtype == torch.float32:
                div, tie_ok = divergences(ref_tokens,
                                          [f.tokens for f in got], prompts,
                                          gaps)
                checks["greedy_equal_but_near_ties"] = tie_ok
            graphs = check_graphs("disagg_serving", engine)
            rows[dtype] = dict(
                checks=checks, graphs=graphs, counts=counts, dg=dg,
                numbers=_serving_numbers(got, counts),
                divergences=div if dtype == torch.float32 else None,
                handoff_ms_p50=float(np.percentile(handoff_ms, 50)),
                handoff_ms_p95=float(np.percentile(handoff_ms, 95)),
                ttft_ms=[f.ttft_ms for f in got])
            if not spec:
                _check_k4(f"disagg_serving {label}", counts, layers)
            del engine
        fp, bf = rows[torch.float32], rows[torch.bfloat16]
        ok = all(fp["checks"].values()) and all(bf["checks"].values())
        launches += bf["counts"]["launches"]
        row = {"phase": "disagg_serving", "model": model, "variant": label,
               "requests": len(prompts), "new_tokens": NEW_TOKENS,
               "fp32_checks": fp["checks"], "bf16_checks": bf["checks"],
               "fp32_greedy_equal_requests":
                   len(prompts) - len(fp["divergences"]),
               "fp32_divergences": fp["divergences"], "tie_gap": TIE_GAP,
               "live_prompt_pages": live_pages,
               "dtype": "bf16", **bf["numbers"],
               "handoff_ms_p50": bf["handoff_ms_p50"],
               "handoff_ms_p95": bf["handoff_ms_p95"],
               "handoff": bf["dg"]["handoff"], "queue": bf["dg"]["queue"],
               "decode_first_fraction": bf["dg"]["decode_first_fraction"],
               "decode_dispatches": bf["counts"]["decode_dispatches"],
               "verify_dispatches": bf["counts"].get("verify_dispatches", 0),
               "handoff_dispatches": bf["counts"].get(
                   "handoff_import_dispatches", 0),
               "decode_step_ms_mean": (bf["counts"]["decode_secs"] * 1e3
                                       / bf["counts"]["decode_dispatches"]),
               "kernel_launches": bf["counts"]["launches"],
               "kernel_launches_int8": bf["counts"]["launches_int8"],
               "programs_warm": bf["counts"]["programs_warm"],
               **bf["graphs"],
               "not_disaggregated": {k: plain.get(k) for k in (
                   "decode_tokens_per_s", "ttft_ms_p50", "ttft_ms_p95",
                   "decode_step_ms_mean")},
               "ok": ok, "nvidia_smi": smi}
        emit(row)
        if not ok:
            raise AssertionError(f"disagg_serving {label}: {row}")
    return launches


def _bf16_weight_bytes(params):
    """Bytes of ``params`` with every leaf of two or more dims in bf16
    and the rest as held: what a bf16-resident engine's weights cost."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return sum(t.numel() * (2 if t.dim() >= 2 else t.element_size())
               for t in tree_leaves(params))


def quant_logit_err(model_config, params, forward, device="cuda"):
    """The max |logit| difference between ``forward`` over the int8-
    resident tree and over ``params`` in bf16, on two rows of 64 tokens
    (the offline probe ``record_quant_logit_err`` takes)."""
    import torch
    from deepspeed_tpu_torch.runtime.quantized_params import \
        quantize_param_tree
    rng = np.random.RandomState(SEED + 11)
    ids = torch.tensor(rng.randint(0, model_config.vocab_size, (2, 64)),
                       dtype=torch.int32, device=device)
    with torch.no_grad():
        fp = forward(params, model_config, ids, dtype=torch.bfloat16)
        q = forward(quantize_param_tree(params, 256), model_config, ids,
                    dtype=torch.bfloat16)
    return float((q - fp).abs().max())


def quantized_weights_serving_phase(smi, model_config, params, model,
                                    forward, requests=8, device="cuda"):
    """47. ``quantize_weights: "int8"`` in bf16 over the bf16 and the int8
    pool, ``requests`` of phase 3's requests: the tokens and the first
    decode step's logits bitwise those of the same engine served the
    dequantized tree (the weights the int8 blocks stand for), K4 (K4q)
    once per layer per decode dispatch, every program a graph.
    :func:`quant_logit_err` against the unquantized tree goes through
    record_quant_logit_err. Prints weight_bytes against weight_bytes_dense
    and the bf16 weights' bytes, decode tokens/s and step ms beside phase
    3's and phase 10's rows (serving phases of the unquantized weights).
    Returns K4's and K4q's launches."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.runtime.quantized_params import (
        dequantize_param_tree, quantize_param_tree)
    prompts = make_prompts(model_config.vocab_size)[:requests]
    layers = model_config.num_layers
    err = quant_logit_err(model_config, params, forward, device)
    launches = {"bf16": 0, "int8": 0}
    for kv, pool in (("bf16", {}), ("int8", {"kv_dtype": "int8"})):
        icfg = {"paged_kv": pool} if pool else {}
        ran = {}
        for name, extra in (("int8_weights", INT8_WEIGHTS),
                            ("dequantized", {})):
            tree = params if extra else dequantize_param_tree(
                quantize_param_tree(params, 256))
            engine = InferenceEngine(model_config, tree, dict(icfg, **extra),
                                     dtype=torch.bfloat16, device=device)
            del tree
            engine.record_quant_logit_err(err)
            rec = {}
            finished, counts = serve(
                engine, prompts, NEW_TOKENS,
                after_warmup=lambda e: rec.update(
                    first=_first_decode_logits(e)))
            ran[name] = dict(tokens=[f.tokens for f in finished],
                             logits=rec["first"]["logits"], counts=counts,
                             graphs=check_graphs("quantized_weights_serving",
                                                 engine),
                             numbers=_serving_numbers(finished, counts),
                             quant=engine.debug_state()["quantization"])
            del engine
        q, d = ran["int8_weights"], ran["dequantized"]
        quant = q["quant"]
        bitwise = q["tokens"] == d["tokens"] and \
            bool(torch.equal(q["logits"], d["logits"]))
        launches[kv] = _check_k4(f"quantized_weights_serving {model} {kv}",
                                 q["counts"], layers, int8=kv == "int8")
        bf16_bytes = _bf16_weight_bytes(params)
        served = last_row("serving", model=model,
                          kv_dtype="bfloat16" if kv == "bf16" else "int8") \
            or {}
        row = {"phase": "quantized_weights_serving", "model": model,
               "dtype": "bf16", "kv_dtype": quant["kv_dtype"],
               "requests": len(prompts), "new_tokens": NEW_TOKENS,
               "weights_resident": quant["weights_resident"],
               "weight_bytes": quant["weight_bytes"],
               "weight_bytes_dense": quant["weight_bytes_dense"],
               "weight_bytes_bf16": bf16_bytes,
               "int8_over_bf16_bytes": quant["weight_bytes"] / bf16_bytes,
               "quant_logit_err": quant["quant_logit_err"],
               "bitwise_dequantized_tree": bitwise,
               **q["numbers"],
               "decode_step_ms_mean": (q["counts"]["decode_secs"] * 1e3
                                       / q["counts"]["decode_dispatches"]),
               "serving_row": {k: served.get(k) for k in (
                   "requests", "decode_tokens_per_s", "decode_step_ms_mean",
                   "ttft_ms_p50")},
               "kernel": "paged_decode_int8" if kv == "int8"
               else "paged_decode",
               "kernel_launches": launches[kv],
               "programs_warm": q["counts"]["programs_warm"], **q["graphs"],
               "ok": bitwise, "nvidia_smi": smi}
        emit(row)
        if not bitwise:
            raise AssertionError(
                f"quantized_weights_serving {model} {kv}: the int8-resident "
                "engine's tokens or first decode logits differ from the "
                "dequantized tree's")
    return launches


def quantized_from_checkpoint_phase(smi, state, device="cuda"):
    """47 (the tag). InferenceEngine.from_checkpoint of phase 40's
    global_step3 with quantize_weights "bf16" (the wire-only mode) and
    "int8": phase 41's requests, tokens and the first decode step's
    logits bitwise those of an engine of run B's in-memory step-3 params
    shipped alike (qwz_distribute_params); K4 once per layer per decode
    step. Returns K4's launches by mode."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference.engine import qwz_distribute_params
    cfg, save_dir = state["config"], state["save_dir"]
    prompts, new_tokens = state["prompts"], state["new_tokens"]
    out, rows = {}, {}
    for mode in ("bf16", "int8"):
        ref = InferenceEngine(
            cfg, qwz_distribute_params(state["params3"], 256, mode),
            {"quantize_weights": mode}, dtype=torch.bfloat16, device=device)
        want = _serve_checked(ref, prompts, new_tokens)
        del ref
        t0 = time.perf_counter()
        engine = InferenceEngine.from_checkpoint(
            save_dir, cfg, tag="global_step3", dtype=torch.bfloat16,
            quantize_weights=mode, device=device)
        load_ms = (time.perf_counter() - t0) * 1e3
        got = _serve_checked(engine, prompts, new_tokens)
        quant = engine.debug_state()["quantization"]
        del engine
        ok = got[0] == want[0] and bool(torch.equal(got[1], want[1])) and \
            not got[3] and got[2] == got[4] * cfg.num_layers
        out[mode] = got[2]
        rows[mode] = {"from_checkpoint_ms": load_ms,
                      "weights_resident": quant["weights_resident"],
                      "weight_bytes": quant["weight_bytes"],
                      "tokens_equal": got[0] == want[0],
                      "logits_bitwise": bool(torch.equal(got[1], want[1])),
                      "kernel_launches": got[2],
                      "decode_dispatches": got[4],
                      "steady_state_recompiles":
                          got[5]["steady_state_recompiles"], "ok": ok}
    emit({"phase": "quantized_from_checkpoint", "model": "gpt2-345m",
          "tag": "global_step3", "modes": rows, "nvidia_smi": smi})
    if not all(r["ok"] for r in rows.values()):
        raise AssertionError(f"quantized_from_checkpoint: {rows}")
    return out


def dense_cache_serving_phase(smi, model_config, params, ref,
                              model="gpt2-345m", device="cuda"):
    """48. ``paged_kv.enabled: false``, the dense slot cache (one max_len
    row per slot plus the scratch row), on phase 3's requests: in fp32
    the tokens equal the paged engine's (``ref``) but at a near-tie; in
    bf16 the KV bytes, decode step ms, decode tokens/s and TTFT beside
    phase 3's row. No paged-decode kernel runs: the dense decode attends
    in plain fp32, as JAX's does."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    prompts = make_prompts(model_config.vocab_size)
    ref_tokens, gaps = ref
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        engine = InferenceEngine(model_config, params, DENSE_CACHE,
                                 dtype=dtype, device=device)
        got, counts = serve(engine, prompts, NEW_TOKENS)
        st = engine.debug_state()
        rows[dtype] = dict(tokens=[f.tokens for f in got], counts=counts,
                           numbers=_serving_numbers(got, counts),
                           graphs=check_graphs("dense_cache_serving",
                                               engine),
                           kv_bytes=engine._kv_bpt * engine._rows
                           * engine.max_len, quant=st["quantization"])
        del engine
    fp, bf = rows[torch.float32], rows[torch.bfloat16]
    div, tie_ok = divergences(ref_tokens, fp["tokens"], prompts, gaps)
    no_k4 = all(r["counts"]["launches"] == 0
                and r["counts"]["launches_int8"] == 0 for r in rows.values())
    plain = last_row("serving", model=model, kv_dtype="bfloat16") or {}
    ok = tie_ok and no_k4
    row = {"phase": "dense_cache_serving", "model": model, "dtype": "bf16",
           "requests": len(prompts), "new_tokens": NEW_TOKENS,
           "fp32_greedy_equal_requests": len(prompts) - len(div),
           "fp32_divergences": div, "tie_gap": TIE_GAP,
           "kv_cache_bytes": bf["kv_bytes"],
           "kv_bytes_per_token": bf["quant"]["kv_pool_bytes_per_token"],
           **bf["numbers"],
           "decode_step_ms_mean": (bf["counts"]["decode_secs"] * 1e3
                                   / bf["counts"]["decode_dispatches"]),
           "decode_dispatches": bf["counts"]["decode_dispatches"],
           "paged": {k: plain.get(k) for k in (
               "kv_pool_bytes_per_token", "decode_tokens_per_s",
               "decode_step_ms_mean", "ttft_ms_p50", "ttft_ms_p95")},
           "k4_launches": 0 if no_k4 else "nonzero",
           "programs_warm": bf["counts"]["programs_warm"], **bf["graphs"],
           "ok": ok, "nvidia_smi": smi}
    emit(row)
    if not ok:
        raise AssertionError(f"dense_cache_serving: {row}")


def generate_phase(smi, model_config, params, model, generate,
                   device="cuda"):
    """49. ``gpt2_generate`` / ``llama_generate``: GEN_BATCH prompts of
    GEN_PROMPT tokens, GEN_NEW new tokens, greedy. The prefill runs K1
    (``masked_flash_fwd``, on its tensor-core body in bf16) once per
    layer a call. In fp32 the tokens equal the serving engine's greedy
    tokens for the same prompts but at a near-tie; in bf16 the ms per
    token. Returns K1's launches of the bf16 call."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    rng = np.random.RandomState(SEED + 9)
    prompts = [rng.randint(0, model_config.vocab_size,
                           size=GEN_PROMPT).tolist() for _ in range(GEN_BATCH)]
    engine = InferenceEngine(model_config, params, {}, dtype=torch.float32,
                             device=device)
    gaps, _ = record_samples(engine)
    ref = [f.tokens for f in serve(engine, prompts, GEN_NEW)[0]]
    del engine
    ids = torch.tensor(prompts, dtype=torch.int32, device=device)
    layers = model_config.num_layers
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        _reset_train_launches()
        if ids.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, model_config, ids, GEN_NEW, dtype=dtype)
        out_host = out.cpu()
        secs = time.perf_counter() - t0
        rows[dtype] = dict(tokens=out_host[:, GEN_PROMPT:].tolist(),
                           secs=secs, k1=mf.masked_flash_fwd.launches,
                           bodies=dict(mf.masked_flash_fwd.bodies),
                           other=mf.masked_flash_dq.launches
                           + mf.masked_flash_dkv.launches)
    fp, bf = rows[torch.float32], rows[torch.bfloat16]
    div, tie_ok = divergences(ref, fp["tokens"], prompts, gaps)
    launches_ok = all(r["k1"] == layers and r["other"] == 0
                      for r in rows.values()) and \
        bf["bodies"].get("mma", 0) == layers
    ok = tie_ok and launches_ok
    row = {"phase": "generate", "model": model, "batch": GEN_BATCH,
           "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
           "fp32_greedy_equal_rows": GEN_BATCH - len(div),
           "fp32_divergences": div, "tie_gap": TIE_GAP,
           "k1_launches": {"fp32": fp["k1"], "bf16": bf["k1"]},
           "k1_bodies_bf16": bf["bodies"],
           "bf16_secs": bf["secs"],
           "bf16_ms_per_token": bf["secs"] * 1e3 / GEN_NEW,
           "fp32_ms_per_token": fp["secs"] * 1e3 / GEN_NEW,
           "ok": ok, "nvidia_smi": smi}
    emit(row)
    if not ok:
        raise AssertionError(f"generate {model}: {row}")
    return bf["k1"]


# --------------------------------------------------- the serving fleet
FLEET_REQUESTS = 8        # phase 52: requests, every other one sampled
FLEET_NEW_TOKENS = 32     # phase 52: new tokens a request
FLEET_TEMPERATURE = 0.7   # phase 52: the sampled requests' temperature
FLEET_KILL = "serve.replica_kill:crash:1"   # child 0's DSTPU_FAULT_ARM


class _TimedEvents:
    """An in-memory router writer: every row, stamped with the host clock
    at its write (``t_host``)."""

    def __init__(self):
        self.rows = []

    def add_event(self, kind, **fields):
        self.rows.append(dict(fields, event=kind,
                              t_host=time.perf_counter()))

    def of(self, kind):
        return [r for r in self.rows if r["event"] == kind]


def _watch_migrations(engines):
    """Wrap the in-process engines' migration pair: right after an
    import's replay, the pages it wrote are compared with the slabs the
    export shipped (bitwise, every leaf), and the ms from the start of
    the export to the end of the import go into a list. Returns (the
    comparisons, the ms)."""
    import torch
    started, equal, ms = {}, [], []
    for eng in engines:
        def export(uid, _f=eng.export_request):
            started[uid] = time.perf_counter()
            return _f(uid)

        def import_(rec, _f=eng.import_request, _eng=eng):
            sid = _f(rec)
            if sid is None:
                return sid
            if _eng.device.type == "cuda":
                torch.cuda.synchronize(_eng.device)
            if rec.uid in started:
                ms.append((time.perf_counter() - started.pop(rec.uid)) * 1e3)
            idx = torch.as_tensor(
                _eng.scheduler.slots[sid].pages[:rec.live_pages],
                device=_eng.device)
            slabs = [rec.kslab, rec.vslab] + (
                [rec.kscale_slab, rec.vscale_slab]
                if rec.kscale_slab is not None else [])
            equal.append(all(torch.equal(c.index_select(1, idx).cpu(), s)
                             for c, s in zip(_eng._cache, slabs)))
            return sid
        eng.export_request, eng.import_request = export, import_
    return equal, ms


def _fleet_numbers(finished, wall_secs, decode_secs=None):
    """Decode tokens (all but each request's first), per second of the
    replicas' decode dispatches (in-process replicas, phase 3's measure)
    and per second of the serving loop's wall time; TTFT p50 and p95."""
    ttft = [f.ttft_ms for f in finished if f.ttft_ms is not None]
    tokens = sum(max(len(f.tokens) - 1, 0) for f in finished)
    out = {"decode_tokens": tokens,
           "decode_tokens_per_s_wall": tokens / wall_secs,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95))}
    if decode_secs:
        out["decode_tokens_per_s"] = tokens / decode_secs
    return out


def fleet_serving_phase(smi, model_config, params, ref, model="gpt2-345m",
                        device="cuda"):
    """50. Two in-process fp32 replicas (the default ``inference`` config,
    migration warmed) behind a ``prefix_affinity`` FleetRouter serve phase
    3's 16 requests: the first 8, one router step, replica 1 drained
    twice, another step, then the other 8 (submitted at once, 16 would
    fill both replicas' 8 slots and leave no room to migrate into). Every
    uid answers once; at least one request migrates alive
    (``migrate_export`` on replica 1, ``migrate_import`` on replica 0);
    the pages each import wrote are bitwise the exported slabs; greedy
    tokens equal ``ref``'s (:func:`fp32_reference`) but at a near-tie;
    the second drain is a no-op; no program is built after warmup and
    K4 runs once per layer per decode dispatch. Prints the fleet's
    decode tokens/s and TTFT beside phase 3's, the migrations, their
    bytes and ms, the shed counts. Returns K4's launches."""
    import torch
    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               Request)
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    prompts = make_prompts(model_config.vocab_size)
    ref_tokens, gaps = ref
    layers = model_config.num_layers
    engines = []
    for _ in range(2):
        eng = InferenceEngine(model_config, params, {}, dtype=torch.float32,
                              device=device)
        eng.warmup()
        eng.warm_migration()
        engines.append(eng)
    imports, mig_ms = _watch_migrations(engines)
    ev = _TimedEvents()
    router = FleetRouter(engines, {"replicas": 2,
                                   "routing": "prefix_affinity"}, writer=ev)
    disp0 = [dict(e.dispatches) for e in engines]
    secs0 = [dict(e.dispatch_secs) for e in engines]
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_int8 = 0
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS, temperature=0.0,
                    seed=i) for i, p in enumerate(prompts)]
    half = len(reqs) // 2
    t0 = time.perf_counter()
    # half the requests first: after one step each replica holds some in
    # flight with slots to spare, so replica 0 can take replica 1's alive
    uids = [router.submit(r) for r in reqs[:half]]
    finished = router.step()
    router.drain(1, reason="fleet_serving")
    router.drain(1, reason="fleet_serving")      # must be a no-op
    finished += router.step()
    uids += [router.submit(r) for r in reqs[half:]]
    finished += router.run()
    wall = time.perf_counter() - t0
    counts = {"launches": paged_decode_attention.launches,
              "launches_int8": paged_decode_attention.launches_int8,
              "decode_dispatches": sum(e.dispatches["decode"] - d["decode"]
                                       for e, d in zip(engines, disp0))}
    decode_secs = sum(e.dispatch_secs["decode"] - s["decode"]
                      for e, s in zip(engines, secs0))
    by_uid = {}
    for f in finished:
        by_uid.setdefault(f.uid, []).append(f)
    once = sorted(by_uid) == sorted(uids) and \
        all(len(v) == 1 for v in by_uid.values())
    got = [by_uid[u][0].tokens for u in uids] if once else []
    div, tie_ok = divergences(ref_tokens, got, prompts, gaps) \
        if once else ([], False)
    begins = [r for r in ev.of("fleet_drain") if r["phase"] == "begin"]
    dbg = router.debug_state()
    graphs = [check_graphs("fleet_serving", e) for e in engines]
    checks = {"every_uid_once": once,
              "migrated_alive": router.total_migrated >= 1,
              "imports_bitwise": bool(imports) and all(imports),
              "greedy_equal_but_near_ties": tie_ok,
              "one_drain_episode": len(begins) == 1
              and dbg["replicas"][1]["status"] == "retired",
              "steady_state_recompiles_0": all(
                  e.steady_state_recompiles == 0 for e in engines),
              "nothing_shed": router.total_shed == 0}
    k4 = _check_k4("fleet_serving", counts, layers)
    plain = last_row("serving", model=model, kv_dtype="bfloat16") or {}
    row = {"phase": "fleet_serving", "model": model, "dtype": "fp32",
           "replicas": 2, "routing": "prefix_affinity",
           "requests": len(prompts), "new_tokens": NEW_TOKENS,
           "checks": checks, "greedy_equal_requests":
               len(prompts) - len(div) if once else 0,
           "divergences": div, "tie_gap": TIE_GAP,
           **_fleet_numbers(finished, wall, decode_secs),
           "wall_secs": wall,
           "single_engine_bf16_phase3": {k: plain.get(k) for k in (
               "decode_tokens_per_s", "ttft_ms_p50", "ttft_ms_p95")},
           "migrations": dbg["migrations"], "migration_ms": mig_ms,
           "imports_checked": len(imports),
           "routed": [r["routed"] for r in dbg["replicas"]],
           "redistributed": dbg["redistributed"], "shed": dbg["shed"],
           "decode_dispatches": counts["decode_dispatches"],
           "kernel_launches": k4, "programs": [g["programs"]
                                               for g in graphs],
           "steady_state_recompiles": [e.steady_state_recompiles
                                       for e in engines],
           "ok": all(checks.values()), "nvidia_smi": smi}
    emit(row)
    router.close()
    del engines, router
    if not row["ok"]:
        raise AssertionError(f"fleet_serving: {checks}")
    return k4


def fleet_swap_phase(smi, state, device="cuda"):
    """51. Two bf16 replicas made from run B's in-memory step-3 params
    (phase 40), then ``router.swap_weights(d, "global_step6")``: both
    report global_step6, and so does every FinishedRequest after it; each
    replica's live parameter tensors are bitwise the step-6 params placed
    as an engine places them; phase 41's requests give phase 41's step-6
    tokens but at a near-tie; K4 once per layer per decode dispatch.
    Prints the swap ms of each replica. Writes no tag. Returns K4's
    launches."""
    import torch
    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               Request)
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg, save_dir = state["config"], state["save_dir"]
    prompts, new_tokens = state["prompts"], state["new_tokens"]
    engines, gaps, swap_ms = [], {}, {}
    for i in range(2):
        eng = InferenceEngine(cfg, state["params3"], {},
                              dtype=torch.bfloat16, device=device)
        eng.warmup()
        gaps[i], _ = record_samples(eng)

        def timed(*a, _f=eng.swap_params, _i=i, **kw):
            t0 = time.perf_counter()
            out = _f(*a, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
            swap_ms[_i] = (time.perf_counter() - t0) * 1e3
            return out
        eng.swap_params = timed
        engines.append(eng)
    router = FleetRouter(engines, {"replicas": 2}, writer=_TimedEvents())
    versions = router.swap_weights(save_dir, tag="global_step6")
    want = engines[0]._place_params(state["params6"])
    bitwise = [all(torch.equal(a, b) for a, b in zip(
        tree_leaves(e.params), tree_leaves(want))) for e in engines]
    del want
    disp0 = [e.dispatches["decode"] for e in engines]
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_int8 = 0
    uids = [router.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                  temperature=0.0, seed=i))
            for i, p in enumerate(prompts)]
    finished = router.run()
    by_uid = {f.uid: f for f in finished}
    once = sorted(by_uid) == sorted(uids) and len(finished) == len(uids)
    got = [by_uid[u].tokens for u in uids] if once else []
    merged = {**gaps[0], **gaps[1]}
    div, tie_ok = divergences(state["tokens6"], got, prompts, merged) \
        if once else ([], False)
    counts = {"launches": paged_decode_attention.launches,
              "launches_int8": paged_decode_attention.launches_int8,
              "decode_dispatches": sum(e.dispatches["decode"] - d
                                       for e, d in zip(engines, disp0))}
    k4 = _check_k4("fleet_swap", counts, cfg.num_layers)
    graphs = [check_graphs("fleet_swap", e) for e in engines]
    checks = {"versions": versions == {0: "global_step6",
                                       1: "global_step6"}
              and all(e.weight_version == "global_step6" for e in engines)
              and all(f.weight_version == "global_step6"
                      for f in finished),
              "live_params_bitwise_step6": all(bitwise),
              "every_uid_once": once,
              "tokens_equal_phase41_but_near_ties": tie_ok}
    row = {"phase": "fleet_swap", "model": "gpt2-345m", "dtype": "bf16",
           "replicas": 2, "tag": "global_step6", "versions": versions,
           "swap_ms": [swap_ms.get(i) for i in range(2)],
           "checks": checks, "requests": len(prompts),
           "new_tokens": new_tokens,
           "equal_requests": len(prompts) - len(div) if once else 0,
           "divergences": div, "tie_gap": TIE_GAP,
           "decode_dispatches": counts["decode_dispatches"],
           "kernel_launches": k4,
           "steady_state_recompiles": [g["steady_state_recompiles"]
                                       for g in graphs],
           "ok": all(checks.values()), "nvidia_smi": smi}
    emit(row)
    router.close()
    del engines, router
    if not row["ok"]:
        raise AssertionError(f"fleet_swap: {checks}")
    return k4


def _fleet_requests(vocab):
    """Phase 52's requests: the first FLEET_REQUESTS prompts of
    make_prompts, request i seeded i; those with i % 4 in (1, 2) sampled
    at FLEET_TEMPERATURE, so each replica of a least-loaded pair holds
    greedy and sampled ones."""
    from deepspeed_tpu_torch.inference import Request
    prompts = make_prompts(vocab)[:FLEET_REQUESTS]
    return prompts, [Request(prompt=p, max_new_tokens=FLEET_NEW_TOKENS,
                             temperature=FLEET_TEMPERATURE
                             if i % 4 in (1, 2) else 0.0,
                             seed=i, uid=5000 + i)
                     for i, p in enumerate(prompts)]


def fleet_process_phase(smi, model_config, params, ref, model="gpt2-345m",
                        device="cuda"):
    """52. Two ``replica_worker`` children on the card, in fp32, each
    warmed for migration, their weights from ``init_seed`` 0 through the
    port's generator (the parent's ``params``), the health plane on with
    a flight file each; child 0 armed with ``DSTPU_FAULT_ARM=`` FLEET_KILL.
    A process-mode router (``max_restarts`` 1, no backoff) serves
    FLEET_REQUESTS requests of FLEET_NEW_TOKENS, half greedy, half sampled
    at FLEET_TEMPERATURE with per-request seeds. Child 0 exits 85
    mid-decode, its deathbed exports are imported by child 1, it is
    relaunched under a new pid and its flight file salvaged; every uid
    answers once; greedy tokens equal ``ref``'s but at a near-tie, sampled
    tokens the parent's own fp32 engine's on the same requests. K4's
    launches are each child's own count, read from its state, and equal
    its decode dispatches x layers. Prints the seconds from spawn to hello
    and from death to the relaunched hello, each child's peak memory, the
    migration bytes and ms from the deathbed frame to the import, and
    the fleet's decode tokens/s. Returns the children's K4 launches."""
    import gc
    import os
    import torch
    from deepspeed_tpu_torch.inference import (FleetRouter, InferenceEngine,
                                               ReplicaProcess,
                                               launch_replica_processes)
    from deepspeed_tpu_torch.inference.rpc import request_from_wire, \
        request_to_wire
    layers = model_config.num_layers
    prompts, reqs = _fleet_requests(model_config.vocab_size)
    # the sampled reference: the parent's own engine on the same requests
    engine = InferenceEngine(model_config, params, {}, dtype=torch.float32,
                             device=device)
    engine.warmup()
    for r in reqs:
        engine.submit(request_from_wire(request_to_wire(r)))
    own = {f.uid: f.tokens for f in engine.run()}
    del engine
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()    # leave the card's memory to the children
    tmp = tempfile.mkdtemp(prefix="fleet_process_")
    ready_at = {}
    wait_ready = ReplicaProcess.wait_ready

    def stamped(self):
        wait_ready(self)
        ready_at.setdefault(self.name, []).append(time.perf_counter())
    spec = {"family": "gpt2", "model_config": model_config._asdict(),
            "init_seed": SEED, "dtype": "float32", "device": device,
            "inference": {}, "warm_migration": True}
    flights = [os.path.join(tmp, f"flight_r{i}.json") for i in range(2)]
    ReplicaProcess.wait_ready = stamped
    t_spawn = time.perf_counter()
    try:
        reps = launch_replica_processes(
            spec, 2, env_by_replica={0: {"DSTPU_FAULT_ARM": FLEET_KILL}},
            spec_by_replica={i: {"observability": {"health": {
                "enabled": True, "flight_path": flights[i]}}}
                for i in range(2)}, log_dir=tmp)
    except BaseException:
        ReplicaProcess.wait_ready = wait_ready
        _print_logs(tmp)
        raise
    ev = _TimedEvents()
    router = None
    try:
        # the armed kill fires once: the relaunched child comes up unarmed
        reps[0]._env.pop("DSTPU_FAULT_ARM", None)
        pid0 = reps[0].pid
        router = FleetRouter(reps, {"process_mode": {
            "enabled": True, "max_restarts": 1, "restart_backoff_s": 0.0}},
            writer=ev)
        frame_at = []
        on_death = router._on_replica_death

        def death(r, err):
            frame_at.append(time.perf_counter())
            return on_death(r, err)
        router._on_replica_death = death
        seen = {}           # (replica, pid) -> (first state, last state)

        def look():
            for i, r in enumerate(reps):
                st = dict(r.last_state)
                first = seen.get((i, r.pid), (st, st))[0]
                seen[(i, r.pid)] = (first, st)
        look()
        t0 = time.perf_counter()
        uids = [router.submit(r) for r in reqs]
        finished = []
        while not router.idle():
            finished += router.step()
            look()
        wall = time.perf_counter() - t0
        dbg = router.debug_state()
        r0 = router.replicas[0]
        by_uid = {}
        for f in finished:
            by_uid.setdefault(f.uid, []).append(f)
        once = sorted(by_uid) == sorted(uids) and \
            all(len(v) == 1 for v in by_uid.values())
        greedy = [i for i, r in enumerate(reqs) if r.temperature == 0]
        sampled = [i for i in range(len(reqs)) if i not in greedy]
        ref_tokens, gaps = ref
        div, tie_ok = divergences(
            [ref_tokens[i][:FLEET_NEW_TOKENS] for i in greedy],
            [by_uid[uids[i]][0].tokens for i in greedy] if once else [],
            [prompts[i] for i in greedy], {}) if once else ([], False)
        # divergences numbers rows by their place in the list: map back
        for d in div:
            i = greedy[d["request"]]
            d["request"] = i
            d["gap"] = gaps.get((i, len(prompts[i]) + d["index"]))
        tie_ok = all(d["gap"] is not None and d["gap"] < TIE_GAP
                     for d in div)
        sampled_equal = once and all(
            by_uid[uids[i]][0].tokens == own[uids[i]] for i in sampled)
        migs = ev.of("serve_migration")
        deaths = ev.of("fleet_replica_death")
        restarts = ev.of("fleet_replica_restart")
        salvage = ev.of("fleet_flight_salvage")
        k4, k4_by_child, k4_ok = 0, {}, True
        for (i, pid), (first, last) in seen.items():
            dd = last.get("decode_dispatches", 0) - \
                first.get("decode_dispatches", 0)
            dense = last["k4_launches"][0] - first["k4_launches"][0]
            int8 = last["k4_launches"][1] - first["k4_launches"][1]
            k4_ok &= dense == dd * layers and int8 == 0
            k4_by_child[f"replica {i} pid {pid}"] = {
                "decode_dispatches": dd, "k4_launches": dense,
                "peak_memory_bytes": last.get("peak_memory_bytes")}
            k4 += dense
        checks = {
            "every_uid_once": once,
            "child0_exit_85": r0.last_exit_code == 85
            and bool(deaths) and deaths[0]["replica"] == 0,
            "deathbed_exports_imported_by_child1": bool(deaths)
            and deaths[0]["exports"] >= 1 and any(
                m["src"] == 0 and m["dst"] == 1 for m in migs),
            "relaunched_new_pid": r0.status == "live" and r0.restarts == 1
            and reps[0].pid != pid0 and bool(restarts)
            and restarts[0]["decision"] == "restarted",
            "flight_salvaged": len(salvage) == 1
            and salvage[0]["trigger"] == "replica_death",
            "greedy_equal_but_near_ties": once and tie_ok,
            "sampled_equal_parent_engine": sampled_equal,
            "k4_launches_equal_decode_dispatches_x_layers": k4_ok and k4 > 0,
            "steady_state_recompiles_0": all(
                r.steady_state_recompiles == 0 for r in reps)}
        ready = {name: [t - t_spawn for t in ts]
                 for name, ts in ready_at.items()}
        row = {"phase": "fleet_process", "model": model, "dtype": "fp32",
               "replicas": 2, "requests": len(reqs),
               "new_tokens": FLEET_NEW_TOKENS, "greedy": len(greedy),
               "sampled": len(sampled), "temperature": FLEET_TEMPERATURE,
               "kill": FLEET_KILL, "checks": checks,
               "spawn_to_hello_s": {n: v[0] for n, v in ready.items()},
               "death_to_relaunched_hello_s": (
                   ready_at["r0"][1] - frame_at[0]
                   if len(ready_at.get("r0", [])) > 1 and frame_at
                   else None),
               "frame_to_import_ms": [(m["t_host"] - frame_at[0]) * 1e3
                                      for m in migs if m["src"] == 0]
               if frame_at else [],
               "migrations": dbg["migrations"],
               "migration_rows": [{k: m[k] for k in (
                   "uid", "src", "dst", "pages", "nbytes", "position",
                   "transfer_ms", "priced_ms")} for m in migs],
               "exit_code": r0.last_exit_code,
               "pids": {"child0_before": pid0, "child0_after": reps[0].pid,
                        "child1": reps[1].pid},
               "children": k4_by_child, "kernel_launches": k4,
               "counted": "each child's paged_decode_attention counts from "
                          "its state, since its hello",
               "divergences": div, "tie_gap": TIE_GAP,
               **_fleet_numbers(finished, wall), "wall_secs": wall,
               "ok": all(checks.values()), "nvidia_smi": smi}
        emit(row)
    except BaseException:
        _print_logs(tmp)
        raise
    finally:
        ReplicaProcess.wait_ready = wait_ready
        if router is not None:
            router.close()
        else:
            for r in reps:
                r.close()
    shutil.rmtree(tmp, ignore_errors=True)
    if not row["ok"]:
        raise AssertionError(f"fleet_process: {checks}")
    return k4


def _print_logs(d):
    """The tail of every replica child's log under ``d``, to stderr."""
    import glob
    import os
    for path in sorted(glob.glob(os.path.join(d, "replica_*.log"))):
        with open(path, "rb") as f:
            tail = f.read()[-6000:].decode("utf-8", "replace")
        print(f"--- {path}\n{tail}", file=sys.stderr, flush=True)



def llama_1b_config():
    from deepspeed_tpu_torch import LlamaConfig
    # the LLAMA_1B geometry of examples/llama/train.py: head_dim 64,
    # SwiGLU width 5504, groups of 4 q heads per kv head
    return LlamaConfig(vocab_size=32128, hidden_size=2048, num_layers=16,
                       num_heads=32, num_kv_heads=8,
                       max_position_embeddings=2048)


def llama_phase(smi):
    """Llama at the LLAMA_1B geometry served over the bf16 pool and over
    the int8 pool, then the model path over both pool types in fp32,
    kernel against plain.
    Returns {"bf16": launches, "int8": launches}."""
    import torch
    from deepspeed_tpu_torch.models.llama import (count_params,
                                                  init_llama_params,
                                                  llama_forward,
                                                  llama_generate)
    cfg = llama_1b_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_llama_params(cfg, gen)
    emit({"phase": "llama_model", "model": "llama-1b",
          "params": count_params(params), "config": cfg._asdict(),
          "head_dim": cfg.head_dim, "inter": cfg.inter,
          "group": cfg.num_heads // cfg.kv_heads})
    runs = {}
    for kv, icfg in (("bf16", {}),
                     ("int8", {"paged_kv": {"kv_dtype": "int8"}})):
        launches, prompts, engine, tokens = serving_phase(
            cfg, params, "cuda", smi, model="llama-1b",
            inference_config=icfg)
        profile_phase(engine, prompts, model="llama-1b")
        runs[kv] = (launches, tokens, engine.debug_state()["quantization"][
            "kv_pool_bytes_per_token"])
        del engine
    spec_launches = spec_decode_serving_phase(
        smi, cfg, params, "llama-1b", runs["bf16"][1])
    graph_vs_eager_phase(smi, cfg, params, "llama-1b", kv_dtype="int8")
    pairs = [(a, b) for ta, tb in zip(runs["bf16"][1], runs["int8"][1])
             for a, b in zip(ta, tb)]
    # printed, not asserted: with random weights a near-tie may flip, and
    # every later token of that request then differs
    emit({"phase": "llama_serving_compare", "model": "llama-1b",
          "kv_pool_bytes_per_token": {"bf16": runs["bf16"][2],
                                      "int8": runs["int8"][2]},
          "int8_over_bf16_bytes": runs["int8"][2] / runs["bf16"][2],
          "greedy_tokens_compared": len(pairs),
          "greedy_token_agreement": float(np.mean([a == b
                                                   for a, b in pairs]))})
    shallow = cfg._replace(num_layers=4)
    keep = {f"h_{i}" for i in range(shallow.num_layers)}
    shallow_params = {k: v for k, v in params.items()
                      if not k.startswith("h_") or k in keep}
    for icfg in ({}, {"paged_kv": {"kv_dtype": "int8"}}):
        model_path_phase(shallow, shallow_params, "cuda", prompts,
                         llama_forward, model="llama-1b-width",
                         inference_config=icfg, decode_steps=3)
    del shallow_params
    quant = quantized_weights_serving_phase(smi, cfg, params, "llama-1b",
                                            llama_forward)
    generated = generate_phase(smi, cfg, params, "llama-1b", llama_generate)
    return dict({kv: r[0] for kv, r in runs.items()}, spec=spec_launches,
                quant=quant, generate=generated)


# ------------------------------------------------------------ training
MAIN_SHAPE = dict(B=8, H=16, Hkv=16, S=1024, D=64, block=128)


def train_inputs(rng, B, H, Hkv, S, D, dtype):
    """q, k, v, do of one masked-flash call on the card, from numpy."""
    import torch
    arrs = [rng.randn(B, H, S, D), rng.randn(B, Hkv, S, D),
            rng.randn(B, Hkv, S, D), rng.randn(B, H, S, D)]
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for a in arrs]


def compare(out, ref, atol, rtol, rms):
    """(worst |a - b| / (atol + rtol |b|), ||a - b|| / ||b||, max |a - b|,
    whether both are within bounds)."""
    import torch
    a, b = out.float(), ref.float()
    d = (a - b).abs()
    ratio = float((d / (atol + rtol * b.abs())).max())
    rel_rms = float(torch.linalg.vector_norm(d)
                    / torch.linalg.vector_norm(b).clamp_min(1e-30))
    ok = bool(torch.isfinite(a).all()) and ratio <= 1.0 and \
        (rms is None or rel_rms <= rms)
    return ratio, rel_rms, float(d.max()), ok


def timed_once(fn, flush):
    """``fn()`` once, the L2 cache flushed before it: its result and its
    CUDA-event ms."""
    import torch
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_train_kernels(name, mask, args, rate, seed=-123457,
                        control=False, key_mask=None, control_mask=None,
                        phase="train_kernel_check", extra=None, flush=None):
    """K1, K2 and K3 against their plain versions on the same inputs;
    the backward kernels get the plain forward's lse and delta, so each
    kernel is held against its own plain version. With ``key_mask`` the
    kernels' key-mask arity runs. With ``control``, a plain version that
    leaves out what the check must catch has to fail the same check on
    every output: with a ``control_mask`` (a BAND mask's tiles taken as
    FULL) the plain versions run over it; else without a key mask (bf16
    only) they run on fp32 copies of the inputs, which leaves out the
    rounding of p and ds before their products; with one, they run
    without the key mask. With ``flush`` each plain call is timed as
    :func:`timed_once` times it, in the row's ``plain_ms``."""
    import torch
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    plain_ms = {}

    def plain(kernel, fn, *a):
        if flush is None:
            return fn(*a)
        out, plain_ms[kernel] = timed_once(lambda: fn(*a), flush)
        return out

    bodies = dict(mf.masked_flash_fwd.bodies)
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, rate, seed, key_mask)
    torch.cuda.synchronize()
    body = _body_ran(mf.masked_flash_fwd, bodies)
    dq_bodies = dict(mf.masked_flash_dq.bodies)
    dkv_bodies = dict(mf.masked_flash_dkv.bodies)
    o_p, lse_p = plain("masked_flash_fwd", mf.masked_flash_fwd_plain, q, k,
                       v, mask, scale, rate, seed, key_mask)
    delta = (do.float() * o_p.float()).sum(-1)
    bwd = (q, k, v, do, lse_p, delta, mask, scale, rate, seed, key_mask)
    dq = mf.masked_flash_dq(*bwd)
    dk, dv = mf.masked_flash_dkv(*bwd)
    torch.cuda.synchronize()
    dq_body = _body_ran(mf.masked_flash_dq, dq_bodies)
    dkv_body = _body_ran(mf.masked_flash_dkv, dkv_bodies)
    dq_p = plain("masked_flash_dq", mf.masked_flash_dq_plain, *bwd)
    dk_p, dv_p = plain("masked_flash_dkv", mf.masked_flash_dkv_plain, *bwd)
    dtype = "fp32" if q.dtype == torch.float32 else "bf16"
    tol = TRAIN_TOL[dtype]
    row = {"phase": phase, "case": name,
           "dtype": str(q.dtype), "shape_q": list(q.shape),
           "shape_kv": list(k.shape), "block": mask.block,
           "body": body[0] if len(body) == 1 else body,
           "dq_body": dq_body[0] if len(dq_body) == 1 else dq_body,
           "dkv_body": dkv_body[0] if len(dkv_body) == 1 else dkv_body,
           "mask_heads": mask.heads, "walked_tiles": mask.nnz,
           "dropout": rate, "key_mask": key_mask is not None,
           "tol": tol, "lse_atol": LSE_ATOL}
    if plain_ms:
        row["plain_ms"] = plain_ms
    if mask.band is not None:
        row.update(fine_block=mask.fine_block, band=list(mask.band),
                   band_tiles=int((mask.kinds[mask.active] != 0).sum()))
    row.update(extra or {})
    if key_mask is not None:
        real = (key_mask == 0).sum(-1)
        row["real_keys_per_row"] = [int(n) for n in real.tolist()]
    refs = {"o": o_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    ok = True
    for key, out in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ratio, rel_rms, err, good = compare(out, refs[key], **tol)
        row[f"{key}_max_abs_err"] = err
        row[f"{key}_worst_ratio"] = ratio
        row[f"{key}_rel_rms"] = rel_rms
        ok &= good
    # rows with no valid entry carry NEG_INF in both
    lse_err = float((lse - lse_p).abs().max())
    row["lse_max_abs_err"] = lse_err
    ok &= lse_err <= LSE_ATOL
    ok &= body == [kernel_body("masked_flash_fwd", dtype)]
    ok &= dq_body == [kernel_body("masked_flash_dq", dtype)]
    ok &= dkv_body == [kernel_body("masked_flash_dkv", dtype)]
    if control:
        c_mask, c_key = mask, None
        if control_mask is not None:
            row["control"] = "KIND_BAND tiles taken as FULL"
            c_args, c_mask, c_key = args, control_mask, key_mask
        elif key_mask is None:
            row["control"] = "fp32 inputs: no rounding of p and ds"
            c_args = [t.float() for t in args]
        else:
            row["control"] = "the key mask left out"
            c_args = args
        c_bwd = (*c_args, lse_p, delta, c_mask, scale, rate, seed, c_key)
        o_c, _ = mf.masked_flash_fwd_plain(*c_args[:3], c_mask, scale, rate,
                                           seed, c_key)
        dq_c = mf.masked_flash_dq_plain(*c_bwd)
        dk_c, dv_c = mf.masked_flash_dkv_plain(*c_bwd)
        for key, out in (("o", o_c), ("dq", dq_c), ("dk", dk_c),
                         ("dv", dv_c)):
            ratio, rel_rms, _, good = compare(out.to(q.dtype), refs[key],
                                              **tol)
            row[f"control_{key}_worst_ratio"] = ratio
            row[f"control_{key}_rel_rms"] = rel_rms
            row[f"control_{key}_fails"] = not good
            ok &= not good
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"masked flash kernels disagree with their "
                             f"plain versions on {name}, or the control "
                             f"passes the check: {row}")
    return row


def train_kernel_check_phase():
    """Returns the main-path case's row at dropout 0."""
    import torch
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    rng = np.random.RandomState(SEED)
    m = MAIN_SHAPE
    main = train_inputs(rng, m["B"], m["H"], m["Hkv"], m["S"], m["D"],
                        torch.bfloat16)
    causal = BlockMask.causal(m["S"], m["block"])
    main_row = check_train_kernels("gpt2_345m_causal_bf16", causal, main,
                                   0.0, control=True)
    check_train_kernels("gpt2_345m_causal_bf16_dropout0.1", causal, main,
                        0.1, control=True)
    check_train_kernels("dense_bf16", BlockMask.dense(512, 512, 128),
                        train_inputs(rng, 2, 8, 8, 512, 64, torch.bfloat16),
                        0.0)
    check_train_kernels("gqa_hkv4_g4_hd128_bf16_dropout0.1",
                        BlockMask.causal(512, 128),
                        train_inputs(rng, 2, 16, 4, 512, 128,
                                     torch.bfloat16), 0.1)
    # K1's and K3's tensor-core bodies at every walk block and at head
    # dims off the mma's depth of 16 (zero-padded to it in shared
    # memory), each with the rounding control
    for walk, d, rate in ((16, 64, 0.1), (32, 72, 0.0), (64, 32, 0.1)):
        check_train_kernels(f"causal_bf16_walk{walk}_hd{d}_dropout{rate}",
                            BlockMask.causal(512, walk),
                            train_inputs(rng, 2, 8, 8, 512, d,
                                         torch.bfloat16), rate,
                            control=True)
    check_train_kernels("gqa_hkv4_g4_causal_bf16_hd40",
                        BlockMask.causal(512, 128),
                        train_inputs(rng, 2, 16, 4, 512, 40, torch.bfloat16),
                        0.0, control=True)
    check_train_kernels("fp32_causal_block64_dropout0.1",
                        BlockMask.causal(256, 64),
                        train_inputs(rng, 2, 4, 2, 256, 64, torch.float32),
                        0.1)
    # per-head layouts at block 16 with an empty block row in each head
    layout = rng.rand(4, 8, 8) < 0.4
    layout[:, 3] = False
    layout[:, :, 0] |= np.arange(8) != 3
    check_train_kernels("per_head_layout_block16_empty_rows_fp32",
                        BlockMask.from_layout(layout, 16),
                        train_inputs(rng, 2, 4, 4, 128, 32, torch.float32),
                        0.0)
    return main_row


def causal_cells(seq_q, seq_k):
    """The (query, key) cells causal attention computes per (batch,
    head): key j of query i for j <= i, of the keys that exist."""
    n = min(seq_q, seq_k)
    return n * (n + 1) // 2 + (seq_q - n) * seq_k


def train_kernel_timing_phase(smi):
    """Median CUDA-event ms of K1, K2 and K3 at the training shapes, the
    L2 flushed before each call, beside the bound, the plain version and
    the library yardstick."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    rng = np.random.RandomState(SEED + 1)
    m = MAIN_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    q, k, v, do = train_inputs(rng, B, H, m["Hkv"], S, D, torch.bfloat16)
    mask = BlockMask.causal(S, m["block"])
    scale = 1.0 / float(np.sqrt(D))
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale)
    delta = (do.float() * o.float()).sum(-1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    bytes_per_s, flops_per_s = card_peaks(smi)
    tile = B * H * S * D * 2
    rowvec = B * H * S * 4
    walks = {"csr": sum(a.nbytes for a in mask.csr()),
             "csc": sum(a.nbytes for a in mask.csc())}

    qs = q.detach().clone().requires_grad_()
    ks = k.detach().clone().requires_grad_()
    vs = v.detach().clone().requires_grad_()
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_fwd_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        TIMED_CALLS, flush)
    sdpa_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                    retain_graph=True), TIMED_CALLS, flush)
    specs = {
        # name: (call, plain call, dots per tile, bytes in, bytes out,
        #        replaces, library ms)
        "masked_flash_fwd": (
            lambda: mf.masked_flash_fwd(q, k, v, mask, scale),
            lambda: mf.masked_flash_fwd_plain(q, k, v, mask, scale),
            2, 3 * tile, tile + rowvec,
            "deepspeed_tpu/ops/attention/masked_flash.py:450", sdpa_fwd_ms),
        "masked_flash_dq": (
            lambda: mf.masked_flash_dq(q, k, v, do, lse, delta, mask, scale),
            lambda: mf.masked_flash_dq_plain(q, k, v, do, lse, delta, mask,
                                             scale),
            3, 4 * tile + 2 * rowvec, tile,
            "deepspeed_tpu/ops/attention/masked_flash.py:532", sdpa_bwd_ms),
        "masked_flash_dkv": (
            lambda: mf.masked_flash_dkv(q, k, v, do, lse, delta, mask,
                                        scale),
            lambda: mf.masked_flash_dkv_plain(q, k, v, do, lse, delta, mask,
                                              scale),
            4, 4 * tile + 2 * rowvec, 2 * tile,
            "deepspeed_tpu/ops/attention/masked_flash.py:604", sdpa_bwd_ms),
    }
    out = {}
    for name, (call, plain, dots, b_in, b_out, replaces, lib) in \
            specs.items():
        kernel_ms = time_ms(call, TIMED_CALLS, flush)
        plain_ms = time_ms(plain, 20, flush)
        # the causal cells' products: what causal attention needs, not
        # the masked-off half of each diagonal tile the kernels walk
        flops = causal_cells(S, S) * H * B * dots * 2 * D
        nbytes = b_in + b_out + walks[
            "csc" if name == "masked_flash_dkv" else "csr"]
        bytes_ms = nbytes / bytes_per_s * 1e3
        ops_ms = flops / flops_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        emit({"phase": "train_kernel_timing", "kernel": name,
              "fma_body_ms": FMA_BODY_MS.get(
                  ("train_kernel_timing", name, "gpt2")),
              "shape": dict(MAIN_SHAPE, dtype="bf16", mask="causal"),
              "walked_tiles_per_bh": mask.nnz,
              "causal_cells_per_bh": causal_cells(S, S), "flops": flops,
              "bytes": nbytes, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": lib,
              "library": ("scaled_dot_product_attention forward"
                          if name == "masked_flash_fwd" else
                          "scaled_dot_product_attention backward "
                          "(dq, dk, dv together)"),
              "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "body": kernel_body(name),
              "achieved_tflop_per_s": flops / kernel_ms / 1e9,
              "nvidia_smi": smi})
        out[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": lib, "bound_ms": bound_ms,
                     "bound_by": bound_by, "replaces": replaces}
    return out


def gpt2_345m_train_config():
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    # the JAX bench's gpt2_train_mfu row: 128-aligned vocab, dropout 0
    return GPT2Config(vocab_size=50304, max_position_embeddings=1024,
                      hidden_size=1024, num_layers=24, num_heads=16,
                      embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)


TRAIN_DS_CONFIG = {"train_micro_batch_size_per_gpu": 8,
                   "gradient_accumulation_steps": 1,
                   "bf16": {"enabled": True},
                   "steps_per_print": 10**9,
                   "zero_optimization": {"stage": 0},
                   "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}


def _train_launches():
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    return {"masked_flash_fwd": mf.masked_flash_fwd.launches,
            "masked_flash_dq": mf.masked_flash_dq.launches,
            "masked_flash_dkv": mf.masked_flash_dkv.launches}


def _reset_train_launches():
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    mf.reset_launches()


# the kernels with a tensor-core body in bf16: K1, K5, K8, K11 and K14 on
# csrc/mma_fwd.cuh, K2, K6, K9, K12 and K15 on csrc/mma_dq.cuh, K3, K7,
# K10, K13 and K16 on csrc/mma_dkv.cuh
MMA_KERNELS = ("masked_flash_fwd", "flash_fwd", "masked_flash_dq",
               "flash_dq", "masked_flash_dkv", "flash_dkv",
               "blocksparse_v2_fwd", "blocksparse_v2_dq",
               "blocksparse_v2_dkv", "bs_fwd", "bs_dq", "bs_dkv",
               "banded_fwd", "banded_dq", "banded_dkv")


def kernel_body(name, dtype="bf16"):
    """The body a kernel runs on ``dtype`` inputs: those of MMA_KERNELS
    in bf16 on the tensor cores ("mma"), the rest and fp32 on the CUDA
    cores ("fma")."""
    return "mma" if name in MMA_KERNELS and dtype == "bf16" else "fma"


def _mma_wrapper(name):
    """The wrapper of one of MMA_KERNELS."""
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    module = (mf if name.startswith("masked") else tf
              if name.startswith("flash") else v2
              if name.startswith("blocksparse_v2") else tb
              if name.startswith("banded") else bs)
    return getattr(module, name)


def _mma_bodies(names=MMA_KERNELS):
    """The launches of ``names`` (of MMA_KERNELS) since their counts were
    last reset, by the body they ran."""
    return {name: dict(_mma_wrapper(name).bodies) for name in names}


def _check_mma_bodies(phase, bodies):
    """A bf16 run: every launch of K1-K3 and K5-K16 ran the tensor-core
    body."""
    if any(b.get("fma", 0) for b in bodies.values()):
        raise AssertionError(f"{phase}: a bf16 launch of K1-K3 or K5-K16 "
                             f"ran the CUDA-core body: {bodies}")


def _body_ran(wrapper, before):
    """The bodies whose count in ``wrapper.bodies`` moved past
    ``before``."""
    return sorted(b for b, n in wrapper.bodies.items()
                  if n != before.get(b, 0))


def training_phase(smi, device="cuda", config=None, batch=8, seq=1024,
                   steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, route=None,
                   profile=True):
    """GPT-2 345M trained through initialize + train_batch on one
    repeated batch. Returns the per-kernel launches of the timed steps
    and their losses. The kernels of ``route`` (:class:`Route`, K1-K3 by
    default) must launch ``per_call`` times per layer per step and no
    other attention kernel at all: FLASH_ROUTE, called inside
    :class:`_FlashKnob`, is training_legacy."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (count_params, gpt2_loss_fn,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.ops.attention import get_attention_options
    cfg = config or gpt2_345m_train_config()
    route = route or MASKED_ROUTE
    on_cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_gpt2_params(cfg, gen)
    n_params = count_params(params)
    ds_config = dict(TRAIN_DS_CONFIG, train_micro_batch_size_per_gpu=batch)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, dtype=torch.bfloat16, deterministic=True),
        model_parameters=params, config=ds_config, device=device)
    del params
    ids = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    data = {"input_ids": ids}
    for _ in range(warmup):
        engine.train_batch(iter([data]))
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(iter([data])))
    if on_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, other = route.launches()
    bodies = _mma_bodies()
    losses = [float(x) for x in losses]
    L, H = cfg.num_layers, cfg.hidden_size
    flops_per_token = 6 * n_params + 12 * L * seq * H
    step_s = wall / steps
    tokens_per_s = batch * seq / step_s
    row = {"phase": "training" + route.suffix,
           "model": "gpt2-345m", "params": n_params,
           "batch": batch, "seq": seq, "dtype": "bf16 over fp32 masters",
           "optimizer": "Adam lr 1e-4", "zero_stage": 0,
           "warmup_steps": warmup, "steps": steps,
           "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token, "losses": losses,
           "kernel_launches": launches, "other_attention_launches": other,
           "launches_by_body": bodies,
           "attention_kernel": get_attention_options().kernel,
           "nvidia_smi": smi}
    if on_cuda:
        _, peak_flops = card_peaks(smi)
        row["mfu"] = flops_per_token * tokens_per_s / peak_flops
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(row)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the repeated batch's loss did not fall: "
                             f"{losses}")
    for name, n in launches.items():
        if n != L * steps * route.per_call[name]:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, want {route.per_call[name]} per "
                                 f"layer per step")
    if any(other.values()):
        raise AssertionError(f"other attention kernels launched: {other}")
    _check_mma_bodies(row["phase"], bodies)
    if on_cuda and profile:
        train_profile_phase(engine, data, row["step_ms"])
        head_phase(engine, cfg, batch, seq, row["step_ms"])
    return launches, losses


def train_profile_phase(engine, data, step_ms, steps=2,
                        phase="train_profile", extra_groups=None):
    """Where a training step's time goes: a torch.profiler window over
    ``steps`` train_batch calls, the kernels' own device time per step
    (one stream, so kernels do not overlap), grouped into the three
    masked-flash kernels, GEMMs, ``extra_groups`` ({group: name keys})
    and the rest; the device idle share is what the kernels leave of the
    unprofiled step time. Returns the row."""
    kernels = device_kernels(
        lambda: [engine.train_batch(iter([data])) for _ in range(steps)],
        steps)
    groups = {"masked_flash_fwd": ("mf_fwd_",),
              "masked_flash_dq": ("mf_dq_",),
              "masked_flash_dkv": ("mf_dkv_",),
              "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas")}
    groups.update(extra_groups or {})
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for name, ms, _ in kernels:
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), "other")
        by_group[group] += ms
    busy_ms = sum(k[1] for k in kernels)
    row = {"phase": phase, "steps": steps, "step_ms": step_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1 - busy_ms / step_ms,
           "ms_per_step_by_group": by_group,
           "kernel_launches_per_step": sum(k[2] for k in kernels),
           "top_kernels": [{"name": k[0][:90], "ms_per_step": k[1],
                            "calls_per_step": k[2]} for k in kernels[:15]]}
    emit(row)
    return row


def head_phase(engine, cfg, batch, seq, step_ms, calls=5, head="wte",
               phase="train_head"):
    """What the tied LM head and cross entropy cost at the training
    shapes: forward and backward of the chunked head, whose (tokens,
    vocab) GEMMs run in fp32 with TF32 off on bf16-rounded operands
    (the JAX head's bf16-operand, fp32-result product), median of
    ``calls`` CUDA-event-timed calls."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import _tied_xent_chunked
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((batch, seq, cfg.hidden_size), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    wte = engine.module_params[head].detach().to(
        torch.bfloat16).requires_grad_()
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                            generator=gen)

    def fwd_bwd():
        loss = _tied_xent_chunked(x, wte, targets, torch.bfloat16)
        torch.autograd.grad(loss, (x, wte))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_ms(fwd_bwd, calls, flush)
    # four (tokens x vocab x hidden) GEMMs: logits, their recompute in the
    # backward, dx and dwte
    flops = 4 * 2 * batch * seq * cfg.vocab_size * cfg.hidden_size
    row = {"phase": phase, "tokens": batch * seq,
           "vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
           "fwd_bwd_ms": ms, "share_of_step": ms / step_ms, "flops": flops,
           "achieved_tflop_per_s": flops / ms / 1e9,
           "matmul": "fp32, TF32 off, bf16-rounded operands"}
    emit(row)
    return row


def training_dropout_phase(steps=3, batch=8, seq=1024, route=None):
    """The gpt2_train_mfu_dropout row's path: GPT-2 345M at dropout 0.1
    (embedding, residual and attention dropout, the last inside the
    kernels of ``route``, K1-K3 by default) for a few train_batch steps;
    finite losses, every kernel of the route launched ``per_call`` times
    per layer per step and no other attention kernel."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn, init_gpt2_params
    cfg = gpt2_345m_train_config()._replace(
        embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, dtype=torch.bfloat16),
        model_parameters=init_gpt2_params(cfg, gen),
        config=dict(TRAIN_DS_CONFIG, train_micro_batch_size_per_gpu=batch))
    ids = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    route = route or MASKED_ROUTE
    _reset_all_launches()
    losses = [float(engine.train_batch(iter([{"input_ids": ids}])))
              for _ in range(steps)]
    launches, other = route.launches()
    bodies = _mma_bodies()
    emit({"phase": "training_dropout" + route.suffix, "model": "gpt2-345m",
          "dropout": 0.1, "steps": steps, "losses": losses,
          "kernel_launches": launches, "other_attention_launches": other,
          "launches_by_body": bodies})
    _check_mma_bodies("training_dropout" + route.suffix, bodies)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite dropout training loss: {losses}")
    for name, n in launches.items():
        if n != cfg.num_layers * steps * route.per_call[name]:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"dropout steps")
    if any(other.values()):
        raise AssertionError(f"other attention kernels launched: {other}")


class _PlainMaskedFlash:
    """Within the block, the masked-flash autograd Function calls the
    three kernels' plain versions instead of their wrappers."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.attention import masked_flash as mf
        self._saved = (mf.masked_flash_fwd, mf.masked_flash_dq,
                       mf.masked_flash_dkv)
        mf.masked_flash_fwd = mf.masked_flash_fwd_plain
        mf.masked_flash_dq = mf.masked_flash_dq_plain
        mf.masked_flash_dkv = mf.masked_flash_dkv_plain
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.attention import masked_flash as mf
        (mf.masked_flash_fwd, mf.masked_flash_dq,
         mf.masked_flash_dkv) = self._saved
        return False


def train_kernel_vs_plain_phase(device="cuda", batch=2, seq=1024,
                                route=None):
    """Loss and every grad of a 2-layer full-width GPT-2 in fp32, through
    the kernels of ``route`` (K1-K3 by default) and through their plain
    versions."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn, init_gpt2_params
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg = gpt2_345m_train_config()._replace(num_layers=2)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    params = init_gpt2_params(cfg, gen)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    ids = np.random.RandomState(SEED + 2).randint(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(device)}
    loss_fn = gpt2_loss_fn(cfg, dtype=torch.float32, deterministic=True)
    route = route or MASKED_ROUTE
    results = {}

    def launches():
        return sum(route.launches()[0].values())
    for path in ("kernel", "plain"):
        before = launches()
        with (route.plain() if path == "plain"
              else contextlib.nullcontext()):
            loss = loss_fn(params, data, None)
            grads = torch.autograd.grad(loss, leaves)
        ran_kernel = launches() > before
        if ran_kernel != (path == "kernel"):
            raise AssertionError(f"the {path} path ran the kernel: "
                                 f"{ran_kernel}")
        results[path] = (float(loss.detach()), grads)
    (lk, gk), (lp, gp) = results["kernel"], results["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gp))
    emit({"phase": "train_kernel_vs_plain" + route.suffix,
          "model": "gpt2-345m-width",
          "layers": 2, "dtype": "fp32", "batch": batch, "seq": seq,
          "loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
          "loss_rtol": TRAIN_MODEL_LOSS_RTOL, "grads": len(gk),
          "worst_grad_rel_err": worst, "grad_tol": TRAIN_MODEL_GRAD_TOL})
    if not (loss_rel <= TRAIN_MODEL_LOSS_RTOL
            and worst <= TRAIN_MODEL_GRAD_TOL):
        raise AssertionError(f"kernel path differs from the plain path: "
                             f"loss {loss_rel}, grads {worst}")


# ---------------------------------------------------------------- BERT
# BERT-large's attention at the bing_bert micro batch: B 8, 16 heads of
# 64, seq 128, one dense tile per (row, head) at block 128
BERT_SHAPE = dict(B=8, H=16, Hkv=16, S=128, D=64, block=128)
BERT_DS_CONFIG = "examples/bing_bert/ds_config.json"
BERT_STEPS, BERT_WARMUP, BERT_STEPS_512 = 10, 2, 3
KPM_NAMES = ("masked_flash_fwd", "masked_flash_dq", "masked_flash_dkv")
# block-sparse BERT-large: examples/bing_bert/train.py --mode sparse at
# seq 2048 (the position table extended from 512), real lengths
# 1024-2048, in two configurations: the file as the repo holds it (fixed,
# per-head layouts at block 16) and its sparse_attention section replaced
# by {"mode": "bslongformer"} (the schema's defaults: block 16, a window
# of 3 blocks, global block 0, one layout for all heads)
SPARSE_DS_CONFIG = "examples/bing_bert/ds_config_sparse.json"
SPARSE_SEQ, SPARSE_MIN_LEN = 2048, 1024
SPARSE_STEPS, SPARSE_WARMUP = 3, 1
# the torch.profiler window over a seq-2048 sparse BERT step (fixed,
# BSLongformer, legacy, v1): one step (two until the fleet phases came)
SPARSE_PROFILE_STEPS = 1
SPARSE_KINDS = ("fixed", "bslongformer")
# the arity each configuration's layout runs K1-K3 in at seq 2048
SPARSE_ARITY = {"fixed": "kpm walk16 heads16",
                "bslongformer": "kpm walk16 heads1"}
SPARSE_SHAPE = dict(B=8, H=16, S=SPARSE_SEQ, D=64)
SPARSE_TIMED_CALLS = 20


def bert_key_mask(rng, batch, seq, min_len, all_pad_rows=(), pad=-1e9):
    """BERT's additive key mask on the card, (B, S) fp32: each row's real
    length drawn from [min_len, seq], ``pad`` on the pads (-1e9:
    bert_encoder's dense mask; -1e30: the sparse route's 'mul' mode),
    every key a pad in ``all_pad_rows``."""
    import torch
    lengths = rng.randint(min_len, seq + 1, size=batch)
    am = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32)
    am[list(all_pad_rows)] = 0.0
    return torch.from_numpy((1.0 - am) * pad).float().cuda()


def bert_kernel_check_phase():
    """K1, K2 and K3 in their key-mask arity against their plain versions
    on the card; each case's control (the plain versions with the key
    mask left out) must fail. Returns the main case's row (dropout 0)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    rng = np.random.RandomState(SEED + 5)
    m = BERT_SHAPE
    bf16 = torch.bfloat16
    main = train_inputs(rng, m["B"], m["H"], m["Hkv"], m["S"], m["D"], bf16)
    dense = BlockMask.dense(m["S"], m["S"], m["block"])
    kpm = bert_key_mask(rng, m["B"], m["S"], 64)
    main_row = check_train_kernels("bert_large_s128_bf16", dense, main, 0.0,
                                   control=True, key_mask=kpm)
    check_train_kernels("bert_large_s128_bf16_dropout0.1", dense, main, 0.1,
                        control=True, key_mask=kpm)
    # an MLM step's dO: 0 on the pad queries and on the rows the loss does
    # not reach, where K3's tensor-core body takes dp = 0 as exact
    reach = torch.from_numpy(np.random.RandomState(SEED + 50).rand(
        m["B"], 1, m["S"], 1) < 0.15).cuda()
    mlm = [*main[:3], main[3] * (reach & (kpm == 0)[:, None, :, None])]
    check_train_kernels("bert_large_s128_mlm_do_bf16_dropout0.1", dense, mlm,
                        0.1, control=True, key_mask=kpm)
    cases = [
        # name, mask, (B, H, Hkv, S, D), dtype, rate, min_len, all-pad rows
        ("bert_large_s512_bf16_dropout0.1", BlockMask.dense(512, 512, 128),
         (8, 16, 16, 512, 64), bf16, 0.1, 256, ()),
        ("all_pad_row_s128_bf16", dense, (4, 16, 16, 128, 64), bf16, 0.0,
         64, (2,)),
        ("gqa_hkv4_g4_hd128_bf16_dropout0.1", BlockMask.dense(256, 256, 128),
         (2, 16, 4, 256, 128), bf16, 0.1, 100, ()),
        ("fp32_block64_dropout0.1", BlockMask.dense(256, 256, 64),
         (2, 4, 4, 256, 64), torch.float32, 0.1, 100, ()),
        ("causal_with_key_mask_bf16", BlockMask.causal(512, 128),
         (2, 8, 8, 512, 64), bf16, 0.0, 200, ()),
    ]
    for name, mask, (B, H, Hkv, S, D), dtype, rate, min_len, pads in cases:
        check_train_kernels(name, mask, train_inputs(rng, B, H, Hkv, S, D,
                                                     dtype),
                            rate, control=True,
                            key_mask=bert_key_mask(rng, B, S, min_len, pads))
    return main_row


def bert_kernel_timing_phase(smi):
    """The key-mask arity of K1, K2 and K3 at BERT-large's attention (B 8,
    H 16, D 64, bf16, dense, block 128) at seq 128 and 512, each timed
    as train_kernel_timing times the causal arity, beside its bound, its
    plain version and SDPA with the same float (B, 1, 1, S) mask."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    rng = np.random.RandomState(SEED + 6)
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for S, min_len in ((128, 64), (512, 256)):
        m = dict(BERT_SHAPE, S=S)
        B, H, D = m["B"], m["H"], m["D"]
        q, k, v, do = train_inputs(rng, B, H, m["Hkv"], S, D, torch.bfloat16)
        kpm = bert_key_mask(rng, B, S, min_len)
        mask = BlockMask.dense(S, S, m["block"])
        scale = 1.0 / float(np.sqrt(D))
        o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, key_mask=kpm)
        delta = (do.float() * o.float()).sum(-1)
        tile = B * H * S * D * 2
        rowvec = B * H * S * 4
        mask_bytes = kpm.numel() * 4
        walks = {"csr": sum(a.nbytes for a in mask.csr()),
                 "csc": sum(a.nbytes for a in mask.csc())}
        am = kpm[:, None, None, :].to(torch.bfloat16)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am), TIMED_CALLS, flush)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), do, retain_graph=True), TIMED_CALLS,
            flush)
        bwd = (q, k, v, do, lse, delta, mask, scale)
        specs = {
            # name: (call, plain call, dots per tile, bytes in, bytes out,
            #        replaces, library ms)
            "masked_flash_fwd": (
                lambda: mf.masked_flash_fwd(q, k, v, mask, scale,
                                            key_mask=kpm),
                lambda: mf.masked_flash_fwd_plain(q, k, v, mask, scale,
                                                  key_mask=kpm),
                2, 3 * tile + mask_bytes, tile + rowvec,
                "deepspeed_tpu/ops/attention/masked_flash.py:495-496 "
                "(the has_kpm arity of _mf_fwd_kernel :450)", sdpa_fwd_ms),
            "masked_flash_dq": (
                lambda: mf.masked_flash_dq(*bwd, key_mask=kpm),
                lambda: mf.masked_flash_dq_plain(*bwd, key_mask=kpm),
                3, 4 * tile + 2 * rowvec + mask_bytes, tile,
                "deepspeed_tpu/ops/attention/masked_flash.py:580-581 "
                "(the has_kpm arity of _mf_dq_kernel :532)", sdpa_bwd_ms),
            "masked_flash_dkv": (
                lambda: mf.masked_flash_dkv(*bwd, key_mask=kpm),
                lambda: mf.masked_flash_dkv_plain(*bwd, key_mask=kpm),
                4, 4 * tile + 2 * rowvec + mask_bytes, 2 * tile,
                "deepspeed_tpu/ops/attention/masked_flash.py:620-621, "
                ":654-655 (the has_kpm arity of _mf_dkv_kernel :604)",
                sdpa_bwd_ms),
        }
        for name, (call, plain, dots, b_in, b_out, replaces, lib) in \
                specs.items():
            kernel_ms = time_ms(call, TIMED_CALLS, flush)
            plain_ms = time_ms(plain, 20, flush)
            # every walked tile's products: the kernels compute the
            # padded keys' scores too (their p is 0), as the Pallas
            # kernels do
            flops = mask.nnz * H * B * dots * 2 * mask.block ** 2 * D
            nbytes = b_in + b_out + walks[
                "csc" if name == "masked_flash_dkv" else "csr"]
            bytes_ms = nbytes / bytes_per_s * 1e3
            ops_ms = flops / flops_per_s * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            emit({"phase": "bert_kernel_timing", "kernel": f"{name}_kpm",
                  "fma_body_ms": FMA_BODY_MS.get(
                      ("bert_kernel_timing", f"{name}_kpm", f"S{S}")),
                  "shape": dict(m, dtype="bf16", mask="dense",
                                key_mask=f"lengths {min_len}-{S}"),
                  "flops": flops, "bytes": nbytes, "kernel_ms": kernel_ms,
                  "plain_ms": plain_ms, "library_ms": lib,
                  "library": ("scaled_dot_product_attention forward, "
                              "float (B, 1, 1, S) mask"
                              if name == "masked_flash_fwd" else
                              "scaled_dot_product_attention backward "
                              "(dq, dk, dv together), float mask"),
                  "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "body": kernel_body(name),
                  "achieved_tflop_per_s": flops / kernel_ms / 1e9,
                  "nvidia_smi": smi})
            out.setdefault(name, {})[S] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": lib,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "replaces": replaces}
    return out


# ------------------------------------------------------ sparse BERT
def sparse_config(kind, ds_config=None, heads=16):
    """The SparsityConfig of ``kind``: "fixed", the sparse_attention
    section of ds_config_sparse.json as the repo holds it; "bslongformer",
    that section replaced in ``ds_config`` by {"mode": "bslongformer"};
    parsed by get_sparse_attention, as examples/bing_bert/train.py
    does."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict
    from deepspeed_tpu_torch.runtime.config import get_sparse_attention
    if ds_config is None:
        with open(SPARSE_DS_CONFIG) as f:
            ds_config = json.load(f)
    if kind == "bslongformer":
        ds_config["sparse_attention"] = {"mode": "bslongformer"}
    return sparsity_config_from_dict(get_sparse_attention(ds_config),
                                     num_heads=heads)


def _no_band(mask):
    """``mask`` with its KIND_BAND tiles taken as FULL: the control."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    return BlockMask(mask.active, np.zeros_like(mask.kinds), mask.block,
                     mask.seq_q, mask.seq_k)


def _empty_in_band_tiles(mask):
    """Rows and columns of walked KIND_BAND tiles that keep no cell."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import KIND_BAND
    b = mask.block
    keep = mask.dense_additive()[0] == 0.0
    tiles = keep.reshape(mask.nq, b, mask.nk, b).transpose(0, 2, 1, 3)
    band = tiles[mask.active[0] & (mask.kinds[0] & KIND_BAND).astype(bool)]
    return {"empty_rows_in_band_tiles": int((~band.any(-1)).sum()),
            "empty_cols_in_band_tiles": int((~band.any(-2)).sum())}


def computed_chunks(mask):
    """The chunks of R x R cells (R = min(walk block, 32)) the kernels
    compute over all mask heads: every chunk of a walked tile, but of a
    KIND_BAND tile only those that keep a cell (the kernels skip the
    others, ``Band::any`` in masked_flash.cu)."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import KIND_BAND
    b = mask.block
    R = min(b, 32)
    f = b // R
    grow = np.ones((f, f), bool)
    walked = np.stack([np.kron(a, grow) for a in mask.active])
    if not mask.has_band:
        return int(walked.sum())
    band = np.stack([np.kron(a & (k & KIND_BAND).astype(bool), grow)
                     for a, k in zip(mask.active, mask.kinds)])
    n = mask.seq_q // R
    live = (mask.dense_additive() == 0.0).reshape(
        mask.heads, n, R, mask.seq_k // R, R).any(axis=(2, 4))
    return int((walked & (~band | live)).sum())


def check_band_kernels(name, mask, args, rate, key_mask):
    """K1-K3 in their band arity against their plain versions
    (TRAIN_TOL); the control: the plain versions with the KIND_BAND
    tiles taken as FULL must fail the same check on every output."""
    if not mask.has_band:
        raise AssertionError(f"{name}: {mask.describe()} has no BAND tile")
    return check_train_kernels(name, mask, args, rate, control=True,
                               key_mask=key_mask,
                               control_mask=_no_band(mask),
                               phase="sparse_kernel_check",
                               extra=_empty_in_band_tiles(mask))


def sparse_kernel_check_phase():
    """K1, K2 and K3 in their KIND_BAND arity against their plain
    versions on the card: BERT-large's attention at S 2048 (B 8, H 16,
    D 64, bf16) under the BSLongformer layout coarsened to walk 128, 64
    and 32, with the sparse route's key mask (real lengths 1024-2048,
    -1e30 on the pads); dropout 0.1; fp32; a causally clipped band; and a
    batch row of pads beside a row with 100 real keys. Returns the main
    case's row (walk 128, dropout 0)."""
    import torch
    from deepspeed_tpu_torch.ops.attention.masked_flash import (NEG_INF,
                                                                BlockMask)
    rng = np.random.RandomState(SEED + 8)
    m = SPARSE_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    bf16 = torch.bfloat16
    sc = sparse_config("bslongformer")
    layout = sc.make_layout(S)
    main = train_inputs(rng, B, H, H, S, D, bf16)
    kpm = bert_key_mask(rng, B, S, SPARSE_MIN_LEN, pad=NEG_INF)
    walk128 = BlockMask.from_layout(layout, sc.block, walk_block=128)
    main_row = check_band_kernels("bert_large_s2048_bslongformer_walk128",
                                  walk128, main, 0.0, kpm)
    for walk in (64, 32):
        check_band_kernels(f"bert_large_s2048_bslongformer_walk{walk}",
                           BlockMask.from_layout(layout, sc.block,
                                                 walk_block=walk),
                           main, 0.0, kpm)
    check_band_kernels("bert_large_s2048_bslongformer_walk128_dropout0.1",
                       walk128, main, 0.1, kpm)
    check_band_kernels(
        "fp32_s512_bslongformer_walk64",
        BlockMask.from_layout(sc.make_layout(512), sc.block, walk_block=64),
        train_inputs(rng, 2, 4, 4, 512, 64, torch.float32), 0.0,
        bert_key_mask(rng, 2, 512, 200, pad=NEG_INF))
    n = 1024 // 16
    rb, cb = np.arange(n)[:, None], np.arange(n)[None, :]
    clipped = ((rb < 1) | (cb < 1) | (np.abs(rb - cb) <= 2)) & (cb <= rb)
    causal = BlockMask.from_layout(clipped[None].astype(np.int32), 16,
                                   walk_block=128)
    if not causal.band[4]:
        raise AssertionError(f"detect_banded missed the clip: {causal.band}")
    check_band_kernels("causal_clipped_band_s1024_walk128_bf16", causal,
                       train_inputs(rng, 2, 8, 8, 1024, 64, bf16), 0.0,
                       bert_key_mask(rng, 2, 1024, 512, pad=NEG_INF))
    kpm_pads = bert_key_mask(rng, 4, 1024, 512, all_pad_rows=(1,),
                             pad=NEG_INF)
    kpm_pads[2, 100:] = NEG_INF
    pads = check_band_kernels(
        "empty_rows_cols_all_pad_row_s1024_walk64_bf16",
        BlockMask.from_layout(sc.make_layout(1024), sc.block,
                              walk_block=64),
        train_inputs(rng, 4, 8, 8, 1024, 64, bf16), 0.0, kpm_pads)
    if not (pads["empty_rows_in_band_tiles"]
            and pads["empty_cols_in_band_tiles"]):
        raise AssertionError(f"no empty row or column in a BAND tile: "
                             f"{pads}")
    return main_row


def sparse_kernel_timing_phase(smi):
    """K1, K2 and K3 at the two main-path shapes of block-sparse
    BERT-large (B 8, H 16, S 2048, D 64, bf16, the sparse route's key
    mask): the fixed per-head layouts at walk 16 (the key-mask arity)
    and the BSLongformer layout at walk 128 (the main path's band
    arity), 64, 32 and the fine walk of 16, timed as train_kernel_timing
    times them. The bound counts the bytes moved once and the FINE
    layout's FLOP, so work spent on the coarse tiles' dropped cells
    shows as distance from it. Library: one scaled_dot_product_attention
    call with the dense float (B, H, S, S) mask of layout plus key mask
    (forward for K1, backward for K2 and K3 together). The fixed walk's
    one plain call of each kernel also holds the kernels against it
    (:func:`check_train_kernels`, TRAIN_TOL, the key mask left out as the
    control). Returns the timings and that check's row."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import (NEG_INF,
                                                                BlockMask)
    rng = np.random.RandomState(SEED + 9)
    m = SPARSE_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    q, k, v, do = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
    kpm = bert_key_mask(rng, B, S, SPARSE_MIN_LEN, pad=NEG_INF)
    scale = 1.0 / float(np.sqrt(D))
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    tile = B * H * S * D * 2
    rowvec = B * H * S * 4
    mask_bytes = kpm.numel() * 4
    replaces = {
        "masked_flash_fwd": "deepspeed_tpu/ops/attention/masked_flash.py:"
                            "413-427 (_partial_keep's band predicate, the "
                            "KIND_BAND arity of _mf_fwd_kernel :450)",
        "masked_flash_dq": "deepspeed_tpu/ops/attention/masked_flash.py:"
                           "413-427 (the KIND_BAND arity of _mf_dq_kernel "
                           ":532)",
        "masked_flash_dkv": "deepspeed_tpu/ops/attention/masked_flash.py:"
                            "413-427 (the KIND_BAND arity of _mf_dkv_kernel "
                            ":604)"}
    out, fixed_row, sweep = {}, None, []
    for kind in SPARSE_KINDS:
        sc = sparse_config(kind, heads=H)
        layout = sc.make_layout(S)
        fine_tiles = int(layout.astype(bool).sum())      # over all H heads
        am = (dense_layout_mask(layout, sc.block)[None]
              + kpm[:, None, None, :]).to(torch.bfloat16)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
        lib = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=am), SPARSE_TIMED_CALLS, flush),
            "bwd": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do, retain_graph=True),
                SPARSE_TIMED_CALLS, flush)}
        del sdpa_out, qs, ks, vs, am
        walks = ((16,) if kind == "fixed" else (128, 64, 32, 0))
        for walk in walks:
            mask = BlockMask.from_layout(layout, sc.block,
                                         walk_block=None if kind == "fixed"
                                         else walk)
            label = f"{kind} walk{mask.block}"
            o, lse = mf.masked_flash_fwd(q, k, v, mask, scale, key_mask=kpm)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, mask, scale)
            meta = {"csr": sum(a.nbytes for a in mask.csr()),
                    "csc": sum(a.nbytes for a in mask.csc())}
            hm = H if mask.heads == 1 else 1
            plain_calls, plain_warm = 3, 1
            if kind == "fixed":
                # the per-tile plain walk of the per-head layouts launches
                # ~1e6 small kernels per call: one timed call of each,
                # whose outputs hold the kernels at this main-path shape
                plain_calls, plain_warm = 1, 0
                fixed_row = check_train_kernels(
                    "bert_large_s2048_fixed_walk16_kpm", mask,
                    (q, k, v, do), 0.0, control=True, key_mask=kpm,
                    phase="sparse_kernel_check", flush=flush)
            specs = {
                # name: (call, plain call, dots per tile, bytes in, out,
                #        library ms)
                "masked_flash_fwd": (
                    lambda: mf.masked_flash_fwd(q, k, v, mask, scale,
                                                key_mask=kpm),
                    lambda: mf.masked_flash_fwd_plain(q, k, v, mask, scale,
                                                      key_mask=kpm),
                    2, 3 * tile + mask_bytes, tile + rowvec, lib["fwd"]),
                "masked_flash_dq": (
                    lambda: mf.masked_flash_dq(*bwd, key_mask=kpm),
                    lambda: mf.masked_flash_dq_plain(*bwd, key_mask=kpm),
                    3, 4 * tile + 2 * rowvec + mask_bytes, tile,
                    lib["bwd"]),
                "masked_flash_dkv": (
                    lambda: mf.masked_flash_dkv(*bwd, key_mask=kpm),
                    lambda: mf.masked_flash_dkv_plain(*bwd, key_mask=kpm),
                    4, 4 * tile + 2 * rowvec + mask_bytes, 2 * tile,
                    lib["bwd"]),
            }
            total = 0.0
            for name, (call, plain, dots, b_in, b_out, lib_ms) in \
                    specs.items():
                kernel_ms = time_ms(call, SPARSE_TIMED_CALLS, flush)
                total += kernel_ms
                if kind == "fixed":
                    plain_ms = fixed_row["plain_ms"][name]
                else:
                    plain_ms = time_ms(plain, plain_calls, flush,
                                       warmup=plain_warm)
                # the fine layout's products: what this data needs
                flops = fine_tiles * B * dots * 2 * sc.block ** 2 * D
                walked = mask.nnz * hm * B * dots * 2 * mask.block ** 2 * D
                chunks = computed_chunks(mask)
                rr = min(mask.block, 32)
                computed = chunks * hm * B * dots * 2 * rr ** 2 * D
                nbytes = b_in + b_out + meta[
                    "csc" if name == "masked_flash_dkv" else "csr"]
                bytes_ms = nbytes / bytes_per_s * 1e3
                ops_ms = flops / flops_per_s * 1e3
                bound_ms = max(bytes_ms, ops_ms)
                bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
                emit({"phase": "sparse_kernel_timing", "kernel": name,
                      "case": label, "arity": mf.arity(kpm, mask),
                      "fma_body_ms": FMA_BODY_MS.get(
                          ("sparse_kernel_timing", name, label)),
                      "shape": dict(m, dtype="bf16", block=mask.block,
                                    fine_block=sc.block,
                                    mask_heads=mask.heads,
                                    key_mask=f"lengths {SPARSE_MIN_LEN}-"
                                             f"{S}, -1e30 on the pads"),
                      "walked_tiles": mask.nnz,
                      "band_tiles": int((mask.kinds[mask.active]
                                         != 0).sum()),
                      "fine_layout_flops": flops, "walked_flops": walked,
                      "computed_chunks": chunks, "chunk": rr,
                      "computed_flops": computed,
                      "bytes": nbytes, "kernel_ms": kernel_ms,
                      "plain_ms": plain_ms, "plain_calls": plain_calls,
                      "library_ms": lib_ms,
                      "library": ("scaled_dot_product_attention forward, "
                                  "float (B, H, S, S) mask"
                                  if name == "masked_flash_fwd" else
                                  "scaled_dot_product_attention backward "
                                  "(dq, dk, dv together), float mask"),
                      "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "body": kernel_body(name),
                      "achieved_tflop_per_s": flops / kernel_ms / 1e9,
                      "nvidia_smi": smi})
                out.setdefault(name, {})[label] = {
                    "ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "replaces": replaces[name]}
            if kind == "bslongformer":            # one mask head
                sweep.append((mask.nnz, computed_chunks(mask),
                              min(mask.block, 32), total / (B * H)))
    emit({"phase": "walk_cost_fit", "kernels": "masked_flash",
          "layout": "bslongformer", "sweep": [
              dict(zip(("tiles", "chunks", "chunk", "ms"), w))
              for w in sweep],
          "units": "per (batch, head); fit in us per tile, chunk, cell",
          "fit": fit_walk_costs(sweep),
          "committed": list(mf.WALK_COSTS["masked_flash"]),
          "rule_walk": BlockMask.from_layout(
              sparse_config("bslongformer", heads=H).make_layout(S),
              16).block, "nvidia_smi": smi})
    return out, fixed_row


def bert_batches(vocab, batch, seq, min_len, n, seed=SEED):
    """``n`` synthetic MLM micro batches in the manner of
    examples/bing_bert/train.py, with each row's real length drawn from
    [min_len, seq]: attention_mask 0 on the pads, labels -100 on the pads
    and on the real tokens not picked (15% picked, replaced by [MASK] =
    103)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (batch, seq))
        lengths = rng.randint(min_len, seq + 1, size=batch)
        am = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
        picked = (rng.rand(batch, seq) < 0.15) & (am == 1)
        labels = np.where(picked, ids, -100).astype(np.int32)
        ids = np.where(picked, 103, ids) * am
        out.append({"input_ids": ids.astype(np.int32),
                    "attention_mask": am, "labels": labels})
    return out


def _kpm_launches():
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    out = {}
    for n in KPM_NAMES:
        w = getattr(mf, n)
        kpm = sum(c for a, c in w.arities.items() if a.startswith("kpm"))
        out[n] = (kpm, w.launches - kpm)
    return out


def sparse_bert_setup(kind, ds_config, params, cfg, seq):
    """examples/bing_bert/train.py --mode sparse, with the reference's
    recipe for sequences past the position table: the SparsityConfig of
    :func:`sparse_config`, and the position table extended to ``seq`` by
    ``SparseAttentionUtils``' model surgery. Returns (sparsity config,
    params, model config, the layout's BlockMask at ``seq``, the
    layout's density)."""
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    from deepspeed_tpu_torch.ops.sparse_attention import \
        SparseAttentionUtils
    sc = sparse_config(kind, ds_config, cfg.num_heads)
    params, cfg, _ = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            params, cfg, max_position=seq, sparsity_config=sc)
    # the gather clamps positions past the table: never lean on it
    if params["pos_emb"].shape[0] < seq or \
            cfg.max_position_embeddings < seq:
        raise AssertionError(f"position table {params['pos_emb'].shape} "
                             f"does not cover seq {seq}")
    layout = sc.make_layout(seq)
    return (sc, params, cfg, BlockMask.from_layout(layout, sc.block),
            float(layout.astype(bool).mean()))


def bert_training_phase(smi, device="cuda", config=None, seq=128,
                        min_len=64, steps=BERT_STEPS, warmup=BERT_WARMUP,
                        profile=True, sparse=None, route=None,
                        randn_ms=None):
    """BERT-large MLM trained through initialize + train_batch with the
    bing_bert config as the repo holds it (Lamb, WarmupLR, clipping 1.0,
    ZeRO 1, micro batch 8, ga 2, bf16 over fp32 masters, dropout 0.1).
    Checks finite losses, the lr of every step against WarmupLR.lr_at,
    the Lamb coefficients inside [min_coeff, max_coeff], and that K1, K2
    and K3 (the kernels of ``route``, :class:`Route`) launched
    ``per_call`` times per layer per micro batch and no other attention
    kernel at all, and that every launch of K1-K3 and K5-K7 is of their
    key-mask arity (of K14-K16 too). Returns the route's launches and the
    losses.

    With ``sparse`` ("fixed" or "bslongformer") the phase is
    bert_sparse_training: ds_config_sparse.json and
    :func:`sparse_bert_setup`, and every launch of K1-K3 must be of the
    one arity the layout gives (``masked_flash.arity``: the key mask at
    walk 16 with 16 mask heads for the fixed per-head layouts, the key
    mask and the band at walk 128 with one mask head for BSLongformer).
    BANDED_ROUTE (called inside :class:`_Legacy`) is
    bert_sparse_training_legacy: the BSLongformer layout runs the banded
    kernels; FLASH_ROUTE (dense, called inside :class:`_FlashKnob`) is
    bert_training_legacy; V1_ROUTE (inside :func:`_v1_flags`) is
    bert_sparse_training_v1: the fixed layouts run K14-K16."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import (BERT_LARGE,
                                                 bert_mlm_loss_fn,
                                                 count_params,
                                                 init_bert_params)
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR
    cfg = config or BERT_LARGE
    route = route or MASKED_ROUTE
    on_cuda = torch.device(device).type == "cuda"
    ds_path = BERT_DS_CONFIG if sparse is None else SPARSE_DS_CONFIG
    with open(ds_path) as f:
        ds_config = json.load(f)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_bert_params(cfg, gen)
    sc = None
    if sparse is not None:
        sc, params, cfg, bmask, density = sparse_bert_setup(
            sparse, ds_config, params, cfg, seq)
        want_arity = mf.arity(True, bmask)
        if config is None and route is MASKED_ROUTE and \
                want_arity != SPARSE_ARITY[sparse]:
            raise AssertionError(f"{sparse} layout walks as {want_arity}, "
                                 f"not {SPARSE_ARITY[sparse]}")
    n_params = count_params(params)
    engine, opt, _, sched = deepspeed_tpu_torch.initialize(
        model=bert_mlm_loss_fn(cfg, dtype=torch.bfloat16,
                               sparsity_config=sc),
        model_parameters=params, config=ds_config, device=device)
    del params
    if not isinstance(sched, WarmupLR):
        raise AssertionError(f"the bing_bert config built {sched!r}")
    want_sched = WarmupLR(**ds_config["scheduler"]["params"])
    micro, ga = (engine.train_micro_batch_size_per_gpu(),
                 engine.gradient_accumulation_steps)
    data = bert_batches(cfg.vocab_size, micro, seq, min_len,
                        n=ga * (warmup + steps + 2))
    it = iter(data)
    for _ in range(warmup):
        engine.train_batch(it)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    losses, lrs, trusts, zero_norms = [], [], [], []
    step0 = engine.global_steps
    t0 = time.perf_counter()
    for _ in range(steps):
        lrs.append(engine.get_lr()[0])
        losses.append(engine.train_batch(it))
        trusts.append(opt.last_trust)
        zero_norms.append(opt.last_zero_norm)
    if on_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, other = route.launches()
    bodies = _mma_bodies()
    launches = _kpm_launches()
    arities = {n: dict(getattr(mf, n).arities) for n in KPM_NAMES}
    flash_arities = {n: dict(getattr(tf, n).arities) for n in FLASH_NAMES}
    v1_arities = _v1_arities()
    losses = [float(x) for x in losses]
    coeffs = torch.stack(trusts).float().cpu()
    zero_norm = torch.stack(zero_norms).cpu()
    want_lrs = [want_sched.lr_at(step0 + i) for i in range(steps)]
    timed = data[ga * warmup:ga * (warmup + steps)]
    real_tokens = sum(int(b["attention_mask"].sum()) for b in timed)
    L, H = cfg.num_layers, cfg.hidden_size
    # per token the step computes (pads included): 6N for the GEMMs'
    # forward and backward, 12 L S H for attention's
    flops_per_token = 6 * n_params + 12 * L * seq * H
    step_s = wall / steps
    tokens_per_s = micro * ga * seq / step_s
    row = {"phase": ("bert_training" if sparse is None
                     else "bert_sparse_training") + route.suffix,
           "model": "bert-large" if config is None else "bert",
           "params": n_params, "config": ds_path,
           "micro_batch": micro, "grad_acc": ga, "seq": seq,
           "real_lengths": f"{min_len}-{seq}",
           "dtype": "bf16 over fp32 masters", "optimizer": "Lamb",
           "zero_stage": engine.zero_optimization_stage(),
           "warmup_steps": warmup, "steps": steps,
           "step_ms": step_s * 1e3,
           "samples_per_s": micro * ga / step_s,
           "real_tokens_per_s": real_tokens / wall,
           "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu_formula": "(6 N + 12 L S H) x computed tokens/s / dense "
                          "bf16 peak", "losses": losses, "lrs": lrs,
           "lamb_coeff_min": float(coeffs.min()),
           "lamb_coeff_max": float(coeffs.max()),
           "lamb_coeffs_of_zero_norm_leaves": int(zero_norm.sum()),
           "kpm_launches": {n: c[0] for n, c in launches.items()},
           "mask_free_launches": {n: c[1] for n, c in launches.items()},
           "launches_by_arity": arities,
           "route_launches": got, "other_attention_launches": other,
           "launches_by_body": bodies,
           "flash_launches_by_arity": flash_arities,
           "v1_launches_by_arity": v1_arities, "nvidia_smi": smi}
    if sparse is not None:
        row.update(sparse=sparse,
                   sparse_attention=engine._config.sparse_attention,
                   layout_density=density, arity=want_arity,
                   walk_block=bmask.block, mask_heads=bmask.heads,
                   band=None if bmask.band is None else list(bmask.band),
                   position_table=cfg.max_position_embeddings)
    if sparse is not None and route.planned is not None:
        from deepspeed_tpu_torch.ops.sparse_attention import banded
        from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
            planned_kernel
        layout = sc.make_layout(seq)
        plan = banded.plan(layout, sc.block, False)
        row.update(route=planned_kernel(layout, sc.block),
                   banded=None if plan is None else dict(
                       params=list(plan[0]), tiles=list(plan[1])))
        del row["arity"], row["walk_block"], row["mask_heads"], row["band"]
    if on_cuda:
        _, peak_flops = card_peaks(smi)
        row["mfu"] = flops_per_token * tokens_per_s / peak_flops
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(row)
    _check_mma_bodies(row["phase"], bodies)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    if not np.allclose(lrs, want_lrs, rtol=1e-12, atol=0):
        raise AssertionError(f"lr {lrs} != WarmupLR.lr_at {want_lrs}")
    # the ratios are fp32: the bounds as fp32 rounds them
    lo, hi = (float(np.float32(c)) for c in (opt.min_coeff, opt.max_coeff))
    # Lamb's ratio is 1 for a leaf whose weight or update norm is 0 (after
    # a single warm-up step, WarmupLR's step 0 of lr 0, the zero-initialized
    # biases still are), and clamped into [lo, hi] for every other leaf
    clamped = coeffs[~zero_norm].tolist()
    if not (bool((coeffs[zero_norm] == 1.0).all()) and clamped
            and lo <= min(clamped) and max(clamped) <= hi):
        raise AssertionError(
            f"Lamb coefficients: {int(zero_norm.sum())} leaves of norm 0 "
            f"with ratios {coeffs[zero_norm].unique().tolist()} (want 1), "
            f"{len(clamped)} others in [{min(clamped, default=None)}, "
            f"{max(clamped, default=None)}] (want [{lo}, {hi}])")
    calls = L * ga * steps
    want = {n: k * calls for n, k in route.per_call.items()}
    if got != want or any(other.values()):
        raise AssertionError(f"the route's kernels launched {got} (want "
                             f"{want}), the others {other} (want none)")
    # BERT's attention is full with a key mask: K1-K3 and K5-K7 launch
    # that arity only, and on a sparse layout K1-K3 the layout's
    for name, (kpm_n, free_n) in launches.items():
        if free_n != 0 or sparse is not None and \
                set(arities[name]) - {want_arity}:
            raise AssertionError(
                f"{name}: {kpm_n} key-mask launches and {free_n} mask-free "
                f"ones (want 0), by arity {arities[name]}")
    if any(set(a) - {"kpm full"} for a in flash_arities.values()):
        raise AssertionError(f"K5-K7 launched another arity than the key "
                             f"mask's: {flash_arities}")
    if any(set(a) - {"kpm"} for a in v1_arities.values()):
        raise AssertionError(f"K14-K16 launched another arity than the key "
                             f"mask's: {v1_arities}")
    if route.planned is not None and sparse is not None and \
            row["route"] != route.planned:
        raise AssertionError(f"the legacy dispatch planned {row['route']}, "
                             f"want {route.planned}")
    if on_cuda and profile:
        attention = route.label
        if sparse is not None and route is MASKED_ROUTE:
            attention = f"K1-K3 ({want_arity})"
        bert_profile_phase(
            engine, it, row["step_ms"],
            steps=2 if sparse is None else SPARSE_PROFILE_STEPS,
            phase=("bert_profile" if sparse is None
                   else "bert_sparse_profile") + route.suffix,
            attention=attention, kernels=route.profiled, randn_ms=randn_ms)
    return got, losses


def bert_profile_phase(engine, it, step_ms, steps=2, phase="bert_profile",
                       attention="K1-K3 (key-mask arity)",
                       kernels=("mf_fwd_", "mf_dq_",
                                "mf_dkv_"), randn_ms=None):
    """Where a BERT step's time goes: a torch.profiler window over
    ``steps`` train_batch calls, the kernels' device time per step by
    group, and the device idle share left of the unprofiled step time.
    The MLM head's vocab GEMMs are the fp32 ones (TF32 off) and its
    log-softmax; Lamb, the accumulation and the clipping are the
    multi-tensor (foreach) kernels and the norms. With ``randn_ms``
    ({name prefix of ``kernels``: ms}), each of those kernels' device ms
    per launch in the window beside that time (the kernel timed on
    random inputs)."""
    groups = {attention: kernels,
              "mlm head (fp32 GEMMs, log-softmax)": ("sgemm", "f32f32",
                                                     "softmax"),
              "gemm (bf16)": ("gemm", "nvjet", "xmma", "cutlass", "cublas"),
              "lamb, accumulation, clipping (foreach, norms)": (
                  "multi_tensor", "foreach", "norm_kernel", "reduce_kernel")}
    kernels = device_kernels(
        lambda: [engine.train_batch(it) for _ in range(steps)], steps)
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    for name, ms, _ in kernels:
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), "other")
        by_group[group] += ms
    busy_ms = sum(k[1] for k in kernels)
    # each attention kernel's device ms and launches per step
    by_kernel = {prefix: {"ms_per_step": sum(k[1] for k in kernels
                                             if prefix in k[0]),
                          "launches_per_step": sum(k[2] for k in kernels
                                                   if prefix in k[0])}
                 for prefix in groups[attention]}
    per_launch = {}
    for prefix, ms in (randn_ms or {}).items():
        hits = [k for k in kernels if prefix in k[0]]
        calls = sum(k[2] for k in hits)
        mean = sum(k[1] for k in hits) / calls if calls else None
        per_launch[prefix] = {"ms_per_launch": mean,
                              "launches_per_step": calls, "randn_ms": ms,
                              "ratio": mean / ms if calls else None}
    emit({"phase": phase, "steps": steps, "step_ms": step_ms,
          **({"kernel_ms_per_launch": per_launch} if per_launch else {}),
          "device_busy_ms_per_step": busy_ms,
          "device_idle_share": 1 - busy_ms / step_ms,
          "ms_per_step_by_group": by_group,
          "attention_by_kernel": by_kernel,
          "kernel_launches_per_step": sum(k[2] for k in kernels),
          "top_kernels": [{"name": k[0][:90], "ms_per_step": k[1],
                           "calls_per_step": k[2]} for k in kernels[:15]]})


def bert_kernel_vs_plain_phase(device="cuda", batch=4, seq=128,
                               sparse=None, config=None, route=None):
    """A 2-layer full-width BERT-large in fp32 on a padded batch, dropout
    0, through the kernels' key-mask arity and through their plain
    versions: the encoder (a fixed random linear function of its output,
    and every grad of it) at the TRAIN_MODEL_* tolerances, and the MLM
    loss and its grads. The MLM head's product rounds its operands to
    bf16 in an fp32 model too (matmul_bf16_accum_fp32, as in JAX), so a
    value the two paths carry a few fp32 ulps apart may round to
    neighbouring bf16 values there: the loss's grads are held to one bf16
    ulp (BERT_HEAD_GRAD_TOL) of each grad's largest entry. The kernels
    are those of ``route`` (:class:`Route`, K1-K3 by default). With
    ``sparse`` the layers' attention is block-sparse
    (:func:`sparse_bert_setup`): bert_sparse_kernel_vs_plain; BANDED_ROUTE
    inside :class:`_Legacy` is bert_sparse_kernel_vs_plain_legacy;
    FLASH_ROUTE (dense, inside :class:`_FlashKnob`)
    bert_kernel_vs_plain_legacy."""
    import torch
    from deepspeed_tpu_torch.models.bert import (BERT_LARGE, bert_encoder,
                                                 bert_mlm_loss_fn,
                                                 init_bert_params)
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg = config or BERT_LARGE._replace(num_layers=2)
    route = route or MASKED_ROUTE
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    params = init_bert_params(cfg, gen)
    sc, min_len = None, 40
    if sparse is not None:
        with open(SPARSE_DS_CONFIG) as f:
            ds_config = json.load(f)
        sc, params, cfg, bmask, _ = sparse_bert_setup(sparse, ds_config,
                                                      params, cfg, seq)
        min_len = seq // 2
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    data = {k: torch.from_numpy(v).to(device) for k, v in
            bert_batches(cfg.vocab_size, batch, seq, min_len, 1,
                         seed=SEED + 7)[0].items()}
    r = torch.randn((batch, seq, cfg.hidden_size), generator=gen,
                    device=device)
    mlm = bert_mlm_loss_fn(cfg, dtype=torch.float32, deterministic=True,
                           sparsity_config=sc)

    def encoder(p):
        out = bert_encoder(p, cfg, data["input_ids"], data["attention_mask"],
                           dtype=torch.float32, sparsity_config=sc)
        return (out * r).sum()
    row = {"phase": ("bert_kernel_vs_plain" if sparse is None
                     else "bert_sparse_kernel_vs_plain") + route.suffix,
           "model": "bert-large-width", "layers": cfg.num_layers,
           "dtype": "fp32", "batch": batch, "seq": seq,
           "real_lengths": f"{min_len}-{seq}",
           "loss_rtol": TRAIN_MODEL_LOSS_RTOL}
    if sparse is not None and route.planned is None:
        row.update(sparse=sparse, walk_block=bmask.block,
                   mask_heads=bmask.heads)
    elif sparse is not None:
        from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
            planned_kernel
        row.update(sparse=sparse, route=planned_kernel(
            sc.make_layout(seq), sc.block))

    def kernel_launches():
        return sum(route.launches()[0].values())
    ok = True
    for name, fn, grad_tol in (
            ("encoder", encoder, TRAIN_MODEL_GRAD_TOL),
            ("mlm_loss", lambda p: mlm(p, data, None), BERT_HEAD_GRAD_TOL)):
        results = {}
        for path in ("kernel", "plain"):
            before = kernel_launches()
            with (route.plain() if path == "plain"
                  else contextlib.nullcontext()):
                loss = fn(params)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            ran_kernel = kernel_launches() > before
            if ran_kernel != (path == "kernel"):
                raise AssertionError(f"the {path} path ran the kernel: "
                                     f"{ran_kernel}")
            results[path] = (float(loss.detach()), grads)
        (lk, gk), (lp, gp) = results["kernel"], results["plain"]
        pairs = [(a, b) for a, b in zip(gk, gp) if b is not None]
        loss_rel = abs(lk - lp) / abs(lp)
        worst = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30) for a, b in pairs)
        row.update({f"{name}_kernel": lk, f"{name}_plain": lp,
                    f"{name}_rel_err": loss_rel, f"{name}_grads": len(pairs),
                    f"{name}_worst_grad_rel_err": worst,
                    f"{name}_grad_tol": grad_tol})
        ok &= loss_rel <= TRAIN_MODEL_LOSS_RTOL and worst <= grad_tol
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"BERT kernel path differs from the plain "
                             f"path: {row}")


# --------------------------------- block-sparse under a user attn_mask
# SparseSelfAttention with an (S, S) attention mask: the row-run kernels
# K8-K10 at BERT-large's width and the sparse BERT sequence (B 8, H 16,
# S 2048, D 64, bf16), the layouts of ds_config_sparse.json as the repo
# holds it (fixed, block 16, a layout per head, 4 global patterns), the
# sparse route's key mask (real lengths 1024-2048) and a 'mul' mask made
# from the seed that keeps V2_KEEP of the cells
V2_SHAPE = dict(B=8, H=16, S=SPARSE_SEQ, D=64)
V2_NAMES = ("blocksparse_v2_fwd", "blocksparse_v2_dq", "blocksparse_v2_dkv")
V2_KEEP = 0.9
V2_ITERS, V2_WARMUP = 3, 1
V2_REPLACES = {
    "blocksparse_v2_fwd": "deepspeed_tpu/ops/sparse_attention/"
                          "blocksparse_v2.py:143 (_v2_fwd_kernel, has_am)",
    "blocksparse_v2_dq": "deepspeed_tpu/ops/sparse_attention/"
                         "blocksparse_v2.py:205 (_v2_dq_kernel, has_am)",
    "blocksparse_v2_dkv": "deepspeed_tpu/ops/sparse_attention/"
                          "blocksparse_v2.py:262 (_v2_dkv_kernel, has_am)"}
# a BSLongformer layout whose band a coarse walk of K1-K3 holds in few
# chunks (a window of 5 blocks: most live 32 x 32 chunks are full),
# walked at 128: the band arity's main path
BAND_PATH_SPARSE = {"mode": "bslongformer", "num_sliding_window_blocks": 5}
BAND_PATH_WALK = 128
BAND_PATH_ARITY = f"kpm+band walk{BAND_PATH_WALK} heads1"


def _v2_launches():
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2
    return {n: getattr(blocksparse_v2, n).launches for n in V2_NAMES}


def v2_mask(rng, S, mode="mul", dropped_rows=()):
    """An (S, S) attention mask on the card, made from the seed: 'mul'
    keeps V2_KEEP of the cells (1) and drops the others (0), every key of
    ``dropped_rows``; 'add' holds N(0, 1) values, -1e4 where 'mul'
    drops."""
    import torch
    keep = (rng.rand(S, S) < V2_KEEP).astype(np.float32)
    keep[list(dropped_rows)] = 0.0
    if mode == "add":
        keep = np.where(keep == 0, -1e4, rng.randn(S, S)).astype(np.float32)
    return torch.from_numpy(keep).cuda()


def v2_plan(layout, block, walk=None):
    """The row-run walk of ``layout``: the rule's (``walk`` None), the
    fine one (0) or a forced coarse walk."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import \
        RowRunPlan
    if walk is None:
        walk = bs._pick_coarse_block(layout, block, True)
    return RowRunPlan(layout, block, walk or None)


def check_v2_kernels(name, plan, args, key_mask, am_add, flush=None,
                     extra=None, phase="v2_kernel_check",
                     rounding_control=False, far_row=False):
    """K8, K9 and K10 against their plain versions on the same inputs (K9
    and K10 get the plain forward's lse and delta), under TRAIN_TOL; lse
    within LSE_ATOL (a row with no valid key carries its max, <=
    VALID_THRESH, in both); each kernel on the body its dtype runs
    ("body", "dq_body", "dkv_body"), K9's and K10's tensor-core bodies
    with the count of the cells they summed again ("resummed_cells", and
    their share of the walked cells). With ``am_add`` None the no-mask
    arity runs: no tile at the fine walk, the structural tiles on a
    coarse one. The control, which must fail the same check on every
    output (K9 and K10 fed the control forward's lse and delta): the
    plain versions with the mask tiles left out (all 0); where there is
    none, without the key mask; where there is neither, on fp32 copies of
    the inputs, which leaves out the rounding of p and ds. With
    ``rounding_control`` also the plain forward on fp32 copies (p not
    rounded to bf16) must fail it on o, and the plain backward on fp32
    copies (fed the same lse and delta: neither ds nor K10's p rounded to
    bf16) on dq and dk. With ``far_row`` also the plain backward with the
    threshold at v1's -1e28 (fed the same lse and delta: the far row's
    cells at -5e28 drop) must fail it on dq and dk. With ``flush`` each
    plain call is timed once (:func:`timed_once`)."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    tiles = (plan.structural_tiles(q.device) if am_add is None
             else plan.mask_tiles(am_add))
    plain_ms = {}

    def plain(kernel, fn, *a):
        if flush is None:
            return fn(*a)
        out, plain_ms[kernel] = timed_once(lambda: fn(*a), flush)
        return out

    before = _mma_bodies(V2_NAMES)
    o, lse = v2.blocksparse_v2_fwd(q, k, v, key_mask, tiles, plan, scale)
    torch.cuda.synchronize()
    o_p, lse_p = plain("blocksparse_v2_fwd", v2.blocksparse_v2_fwd_plain,
                       q, k, v, key_mask, tiles, plan, scale)
    delta = (do.float() * o_p.float()).sum(-1)
    bwd = (q, k, v, do, lse_p, delta, key_mask, tiles, plan, scale)
    tally = {n: torch.zeros(1, dtype=torch.int64, device=q.device)
             for n in V2_NAMES[1:]}
    dq = v2.blocksparse_v2_dq(*bwd, tally=tally["blocksparse_v2_dq"])
    dk, dv = v2.blocksparse_v2_dkv(*bwd, tally=tally["blocksparse_v2_dkv"])
    torch.cuda.synchronize()
    bodies = {n: _body_ran(_mma_wrapper(n), before[n]) for n in V2_NAMES}
    dq_p = plain("blocksparse_v2_dq", v2.blocksparse_v2_dq_plain, *bwd)
    dk_p, dv_p = plain("blocksparse_v2_dkv", v2.blocksparse_v2_dkv_plain,
                       *bwd)
    dtype = "fp32" if q.dtype == torch.float32 else "bf16"
    tol = TRAIN_TOL[dtype]
    walked = plan.tiles_walked * q.shape[0] * plan.block ** 2
    resummed = {n: int(t.item()) for n, t in tally.items()}
    row = {"phase": phase, "case": name, "dtype": str(q.dtype),
           **{key: b[0] if len(b) == 1 else b for key, b in zip(
               ("body", "dq_body", "dkv_body"), bodies.values())},
           "resummed_cells": resummed, "walked_cells": walked,
           "resummed_share": {n: c / walked for n, c in resummed.items()},
           "shape": list(q.shape), "fine_block": plan.fine_block,
           "walk_block": plan.block, "walked_tiles": plan.tiles_walked,
           "unique_tiles": plan.unique_tiles, "tiles": tiles is not None,
           "key_mask": key_mask is not None,
           "rows_with_no_key": int((lse_p <= v2.VALID_THRESH).sum()),
           "tol": tol, "lse_atol": LSE_ATOL}
    if plain_ms:
        row["plain_ms"] = plain_ms
    row.update(extra or {})
    refs = {"o": o_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    ok = True
    for key, out in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ratio, rel_rms, err, good = compare(out, refs[key], **tol)
        row[f"{key}_max_abs_err"] = err
        row[f"{key}_worst_ratio"] = ratio
        row[f"{key}_rel_rms"] = rel_rms
        ok &= good
    lse_err = float((lse - lse_p).abs().max())
    row["lse_max_abs_err"] = lse_err
    ok &= lse_err <= LSE_ATOL
    ok &= bodies == {n: [kernel_body(n, dtype)] for n in V2_NAMES}

    def backward_control(label, bwd_c, ctx=contextlib.nullcontext()):
        """The plain dq and dk of ``bwd_c`` must fail the check."""
        with ctx:
            got = {"dq": v2.blocksparse_v2_dq_plain(*bwd_c),
                   "dk": v2.blocksparse_v2_dkv_plain(*bwd_c)[0]}
        control = {"control": label}
        good_any = False
        for key, out in got.items():
            ratio, rel_rms, _, good = compare(out.to(q.dtype), refs[key],
                                              **tol)
            control.update({f"{key}_worst_ratio": ratio,
                            f"{key}_rel_rms": rel_rms,
                            f"{key}_fails": not good})
            good_any |= good
        return control, not good_any

    if rounding_control:
        fp32 = [t.float() for t in args]
        o_r, _ = v2.blocksparse_v2_fwd_plain(*fp32[:3], key_mask, tiles,
                                             plan, scale)
        ratio, rel_rms, _, good = compare(o_r.to(q.dtype), o_p, **tol)
        row["rounding_control"] = {
            "control": "the plain forward on fp32 inputs: p not rounded "
                       "to bf16", "o_worst_ratio": ratio,
            "o_rel_rms": rel_rms, "o_fails": not good}
        ok &= not good
        row["backward_rounding_control"], fails = backward_control(
            "the plain backward on fp32 inputs: neither ds nor K10's p "
            "rounded to bf16", (*fp32, *bwd[4:]))
        ok &= fails
    if far_row:
        row["threshold_control"], fails = backward_control(
            "the plain backward with the threshold at -1e28", bwd,
            _attrs(v2, VALID_THRESH=-1e28))
        ok &= fails
    c_args, c_key, c_tiles = args, key_mask, tiles
    if tiles is not None:
        row["control"] = "the mask tiles left out"
        c_tiles = torch.zeros_like(tiles)
    elif key_mask is not None:
        row["control"] = "the key mask left out"
        c_key = None
    else:
        row["control"] = "fp32 inputs: no rounding of p and ds"
        c_args = [t.float() for t in args]
    o_c, lse_c = v2.blocksparse_v2_fwd_plain(*c_args[:3], c_key, c_tiles,
                                             plan, scale)
    c_bwd = (*c_args, lse_c, (c_args[3].float() * o_c.float()).sum(-1),
             c_key, c_tiles, plan, scale)
    dq_c = v2.blocksparse_v2_dq_plain(*c_bwd)
    dk_c, dv_c = v2.blocksparse_v2_dkv_plain(*c_bwd)
    for key, out in (("o", o_c), ("dq", dq_c), ("dk", dk_c), ("dv", dv_c)):
        ratio, rel_rms, _, good = compare(out.to(q.dtype), refs[key], **tol)
        row[f"control_{key}_worst_ratio"] = ratio
        row[f"control_{key}_rel_rms"] = rel_rms
        row[f"control_{key}_fails"] = not good
        ok &= not good
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"the row-run kernels disagree with their "
                             f"plain versions on {name}, or a control "
                             f"passes the check: {row}")
    return row


def v2_kernel_check_phase():
    """K8, K9 and K10 against their plain versions on the card: the main
    shape (the fixed per-head layouts at the walk the rule picks, a 'mul'
    mask, the key mask), the plain calls timed once; then at S 512: 'add'
    mode with finite values, the BigBird layout under a causal keep mask
    (tests/unit/test_sparse_attention.py:200), fp32, forced coarse walks,
    and mask rows that drop every key beside a batch row of pads. Returns
    the main case's row."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig)
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
        NEG_INF, _to_additive)
    rng = np.random.RandomState(SEED + 10)
    m = V2_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    bf16 = torch.bfloat16
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    layout = sparse_config("fixed", heads=H).make_layout(S)
    main = train_inputs(rng, B, H, H, S, D, bf16)
    kpm = bert_key_mask(rng, B, S, SPARSE_MIN_LEN, pad=NEG_INF)
    plan = v2_plan(layout, 16)
    main_row = check_v2_kernels(
        f"bert_large_s2048_fixed_mul_walk{plan.block}", plan, main, kpm,
        _to_additive(v2_mask(rng, S), "mul"), flush=flush,
        rounding_control=True)
    del main, flush
    b, h, s = 2, 4, 512
    small = sparse_config("fixed", heads=h).make_layout(s)
    bigbird = BigBirdSparsityConfig(num_heads=h, block=16).make_layout(s)
    causal = torch.ones(s, s, device="cuda").tril()
    cases = [
        # name, layout, walk, dtype, mask (additive), all-pad batch rows
        ("add_finite_s512_bf16", small, 0, bf16,
         _to_additive(v2_mask(rng, s, "add"), "add"), ()),
        ("bigbird_causal_keep_s512_bf16", bigbird, 0, bf16,
         _to_additive(causal, "mul"), ()),
        ("fp32_s512", small, 0, torch.float32,
         _to_additive(v2_mask(rng, s), "mul"), ()),
        ("forced_walk64_s512_bf16", small, 64, bf16,
         _to_additive(v2_mask(rng, s), "mul"), ()),
        ("forced_walk128_s512_fp32", small, 128, torch.float32,
         _to_additive(v2_mask(rng, s, "add"), "add"), ()),
        ("dropped_rows_pad_row_s512_bf16", small, 0, bf16,
         _to_additive(v2_mask(rng, s, dropped_rows=(5, 300, 301)), "mul"),
         (1,)),
    ]
    for name, lay, walk, dtype, am_add, pads in cases:
        row = check_v2_kernels(
            name, v2_plan(lay, 16, walk),
            train_inputs(rng, b, h, h, s, 64, dtype),
            bert_key_mask(rng, b, s, 200, all_pad_rows=pads, pad=NEG_INF),
            am_add)
        if pads and row["rows_with_no_key"] < h * s + 3 * (b - 1) * h:
            raise AssertionError(f"{name}: expected the pad row and the "
                                 f"dropped rows keyless: {row}")
    # K9's and K10's bf16 bodies at a walk of 128 (two CTAs share each
    # tile) and head dim 128, and the row whose only keys sit at -5e28,
    # which -1e29 keeps and v1's -1e28 would drop
    check_v2_kernels(
        "forced_walk128_d128_s512_bf16", v2_plan(small, 16, 128),
        train_inputs(rng, b, h, h, s, 128, bf16),
        bert_key_mask(rng, b, s, 200, pad=NEG_INF),
        _to_additive(v2_mask(rng, s, "add"), "add"))
    check_v2_kernels(
        "far_row_s512_bf16", v2_plan(small, 16, 0),
        train_inputs(rng, b, h, h, s, 64, bf16),
        bert_key_mask(rng, b, s, 200, pad=NEG_INF),
        v1_far_mask(rng, small, s, 16), far_row=True)
    return main_row


def fit_walk_costs(sweep):
    """Non-negative least-squares (us per tile, per chunk, per cell) of a
    walk sweep: rows of (tiles, chunks, chunk, ms of the three kernels
    together) per (batch, head); masked_flash.WALK_COSTS holds such
    fits."""
    from scipy.optimize import nnls
    a = np.array([[t, c, c * r * r] for t, c, r, _ in sweep], float)
    y = np.array([ms for *_, ms in sweep], float) * 1e3
    return [float(x) for x in nnls(a, y)[0]]


def v2_kernel_timing_phase(smi, main_row):
    """K8, K9 and K10 at the main shape, timed as train_kernel_timing
    times them, at the fine walk and every coarse walk the tile budget
    admits, beside the bound (bytes moved once, or the fine layout's
    FLOP), the plain versions (one call each, from ``main_row``, at the
    rule's walk) and SDPA with the dense float (B, H, S, S) mask of
    layout, key mask and attention mask (forward for K8, backward for K9
    and K10 together). The sweep is fitted to the cost model of
    masked_flash.walk_cost_us. Returns the timings at the rule's walk."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention.masked_flash import (CHUNK,
                                                                WALK_COSTS)
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
        NEG_INF, _to_additive)
    rng = np.random.RandomState(SEED + 11)
    m = V2_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    q, k, v, do = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
    kpm = bert_key_mask(rng, B, S, SPARSE_MIN_LEN, pad=NEG_INF)
    am_add = _to_additive(v2_mask(rng, S), "mul")
    scale = 1.0 / float(np.sqrt(D))
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    layout = sparse_config("fixed", heads=H).make_layout(S)
    fine_tiles = int(layout.astype(bool).sum())          # over all H heads
    dense = (dense_layout_mask(layout, 16)[None] + kpm[:, None, None, :]
             + am_add[None, None]).to(torch.bfloat16)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=dense)
    lib = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=dense), SPARSE_TIMED_CALLS, flush),
        "bwd": time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), do, retain_graph=True),
            SPARSE_TIMED_CALLS, flush)}
    del sdpa_out, qs, ks, vs, dense
    tile = B * H * S * D * 2
    rowvec = B * H * S * 4
    rule_walk = v2_plan(layout, 16).block
    walks = [0] + [cb for cb in (32, 64, 128) if bs.build_coarse_index(
        layout, 16, cb, per_coord=True, count_only=True)[1] * cb * cb * 4
        <= bs._COARSE_TILE_BUDGET]
    out, sweep = {}, []
    for walk in walks:
        plan = v2_plan(layout, 16, walk)
        tiles = plan.mask_tiles(am_add)
        v2.reset_launches()
        o, lse = v2.blocksparse_v2_fwd(q, k, v, kpm, tiles, plan, scale)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, kpm, tiles, plan, scale)
        meta = {"csr": sum(a.nbytes for a in plan.csr),
                "csc": sum(a.nbytes for a in plan.csc)}
        masks = kpm.numel() * 4 + tiles.numel() * 4
        specs = {
            # name: (call, dots per tile, bytes in, bytes out, library ms)
            "blocksparse_v2_fwd": (
                lambda: v2.blocksparse_v2_fwd(q, k, v, kpm, tiles, plan,
                                              scale),
                2, 3 * tile + masks + meta["csr"], tile + rowvec,
                lib["fwd"]),
            "blocksparse_v2_dq": (
                lambda: v2.blocksparse_v2_dq(*bwd),
                3, 4 * tile + 2 * rowvec + masks + meta["csr"], tile,
                lib["bwd"]),
            "blocksparse_v2_dkv": (
                lambda: v2.blocksparse_v2_dkv(*bwd),
                4, 4 * tile + 2 * rowvec + masks + meta["csc"], 2 * tile,
                lib["bwd"]),
        }
        total = 0.0
        for name, (call, dots, b_in, b_out, lib_ms) in specs.items():
            kernel_ms = time_ms(call, SPARSE_TIMED_CALLS, flush)
            total += kernel_ms
            # the fine layout's products: what this data needs
            flops = fine_tiles * B * dots * 2 * 16 ** 2 * D
            walked = plan.tiles_walked * B * dots * 2 * plan.block ** 2 * D
            nbytes = b_in + b_out
            bytes_ms = nbytes / bytes_per_s * 1e3
            ops_ms = flops / flops_per_s * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            main = plan.block == rule_walk
            plain_ms = main_row["plain_ms"][name] if main else None
            case = f"fixed walk{plan.block}"
            emit({"phase": "v2_kernel_timing", "kernel": name,
                  "case": case, "rule_walk": main,
                  "body": kernel_body(name),
                  "fma_body_ms": FMA_BODY_MS.get(
                      ("v2_kernel_timing", name, case)),
                  "shape": dict(m, dtype="bf16", block=plan.block,
                                fine_block=16, mask="'mul', keeps "
                                f"{V2_KEEP}", key_mask=f"lengths "
                                f"{SPARSE_MIN_LEN}-{S}, -1e30 on the pads"),
                  "walked_tiles": plan.tiles_walked,
                  "unique_tiles": plan.unique_tiles,
                  "fine_layout_flops": flops, "walked_flops": walked,
                  "bytes": nbytes, "kernel_ms": kernel_ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library": ("scaled_dot_product_attention forward, "
                              "float (B, H, S, S) mask"
                              if name == "blocksparse_v2_fwd" else
                              "scaled_dot_product_attention backward "
                              "(dq, dk, dv together), float mask"),
                  "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "achieved_tflop_per_s": flops / kernel_ms / 1e9,
                  "nvidia_smi": smi})
            if main:
                out[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by,
                             "replaces": V2_REPLACES[name],
                             "fma_body_ms": FMA_BODY_MS.get(
                                 ("v2_kernel_timing", name, case))}
        _check_mma_bodies("v2_kernel_timing", _mma_bodies(V2_NAMES))
        r = min(plan.block, CHUNK)
        per_bh = B * H
        sweep.append((plan.tiles_walked * B / per_bh,
                      plan.tiles_walked * (plan.block // r) ** 2 * B
                      / per_bh, r, total / per_bh))
    fit = fit_walk_costs(sweep)
    emit({"phase": "walk_cost_fit", "kernels": "blocksparse_v2",
          "sweep": [dict(zip(("tiles", "chunks", "chunk", "ms"), s))
                    for s in sweep],
          "units": "per (batch, head); fit in us per tile, chunk, cell",
          "fit": fit, "committed": list(WALK_COSTS["blocksparse_v2"]),
          "rule_walk": rule_walk, "nvidia_smi": smi})
    v2_walk_picks(smi)
    return out


def _v2_pick_layouts():
    """Layouts (H 16, block 16) on which the walk rule's pick hangs on the
    costs: a fit of the main layout's sweep alone (walk_cost_fit) would
    coarsen each of them; the committed costs walk the pure global one at
    32, the dense one at 128 and the others fine."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig,
        DenseSparsityConfig, FixedSparsityConfig)
    H, b = V2_SHAPE["H"], 16
    glob = ((np.arange(8)[:, None] < 2) | (np.arange(8)[None, :] < 2))
    return {
        "fixed per head S128": FixedSparsityConfig(
            num_heads=H, block=b, num_local_blocks=2,
            different_layout_per_head=True,
            num_different_global_patterns=2).make_layout(128),
        "bigbird S128": BigBirdSparsityConfig(
            num_heads=H, block=b, num_random_blocks=1).make_layout(128),
        "pure global S128": np.broadcast_to(glob.astype(np.int32),
                                            (H, 8, 8)).copy(),
        "bslongformer w5 g0-2 S256": BSLongformerSparsityConfig(
            num_heads=H, block=b, num_sliding_window_blocks=5,
            global_block_indices=[0],
            global_block_end_indices=[2]).make_layout(256),
        "bslongformer w15 S512": BSLongformerSparsityConfig(
            num_heads=H, block=b,
            num_sliding_window_blocks=15).make_layout(512),
        "dense S512": DenseSparsityConfig(num_heads=H,
                                          block=b).make_layout(512),
    }


def v2_walk_picks(smi):
    """The end of phase 22: K8, K9 and K10 together (bf16, B 8, H 16,
    D 64, a key mask and a 'mul' mask as at the main shape) on each of
    _v2_pick_layouts at the fine walk and every coarse walk the tile
    budget admits, beside the walk the committed costs pick and their
    modeled us per (batch, head) for each walk."""
    import torch
    from deepspeed_tpu_torch.ops.attention.masked_flash import (
        CHUNK, walk_cost_us)
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
        NEG_INF, _to_additive)
    B, D = V2_SHAPE["B"], V2_SHAPE["D"]
    scale = 1.0 / float(np.sqrt(D))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rng = np.random.RandomState(SEED + 12)
    for name, layout in _v2_pick_layouts().items():
        H, S = layout.shape[0], layout.shape[1] * 16
        q, k, v, do = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
        kpm = bert_key_mask(rng, B, S, S // 2, pad=NEG_INF)
        am_add = _to_additive(v2_mask(rng, S), "mul")
        walks = [0] + [cb for cb in (32, 64, 128) if S % cb == 0
                       and bs.build_coarse_index(
                           layout, 16, cb, per_coord=True,
                           count_only=True)[1] * cb * cb * 4
                       <= bs._COARSE_TILE_BUDGET]
        ms, model_us = {}, {}
        for walk in walks:
            plan = v2_plan(layout, 16, walk)
            tiles = plan.mask_tiles(am_add)
            o, lse = v2.blocksparse_v2_fwd(q, k, v, kpm, tiles, plan, scale)
            delta = (do.float() * o.float()).sum(-1)
            bwd = (q, k, v, do, lse, delta, kpm, tiles, plan, scale)

            def step():
                v2.blocksparse_v2_fwd(q, k, v, kpm, tiles, plan, scale)
                v2.blocksparse_v2_dq(*bwd)
                v2.blocksparse_v2_dkv(*bwd)
            ms[plan.block] = time_ms(step, SPARSE_TIMED_CALLS, flush)
            r = min(plan.block, CHUNK)
            n = plan.tiles_walked / H
            model_us[plan.block] = walk_cost_us(
                "blocksparse_v2", n, n * (plan.block // r) ** 2, r)
        _check_mma_bodies("v2_walk_picks", _mma_bodies(V2_NAMES))
        emit({"phase": "v2_walk_picks", "layout": name,
              "shape": dict(B=B, H=H, S=S, D=D, dtype="bf16",
                            fine_block=16, mask="'mul', keeps "
                            f"{V2_KEEP}", key_mask=f"lengths {S // 2}-{S}"),
              "fine_tiles": int(layout.astype(bool).sum()),
              "ms_by_walk": ms,
              "committed_model_us_per_bh_by_walk": model_us,
              "rule_walk": bs._pick_coarse_block(layout, 16, True) or 16,
              "fastest_walk": min(ms, key=ms.get), "nvidia_smi": smi})


class _PlainRowRun:
    """Within the block, the row-run autograd Function calls the three
    kernels' plain versions instead of their wrappers."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2
        self._saved = tuple(getattr(blocksparse_v2, n) for n in V2_NAMES)
        for n in V2_NAMES:
            setattr(blocksparse_v2, n, getattr(blocksparse_v2, n + "_plain"))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2
        for n, fn in zip(V2_NAMES, self._saved):
            setattr(blocksparse_v2, n, fn)
        return False


def sparse_self_attention_phase(smi):
    """The entry point: SparseSelfAttention with the sparse_attention
    section of ds_config_sparse.json (sparsity_config_from_dict), the key
    mask in 'mul' mode (real lengths 1024-2048) and an (S, S) 'mul' mask,
    on bf16 q, k, v of (8, 16, 2048, 64) that require grad: the forward
    and the backward of a scalar loss, 1 warm-up and V2_ITERS timed
    iterations. Checks finite outputs and grads, one launch of each of
    K8, K9 and K10 per iteration and none of K1-K3. Then a 2-head fp32
    call on the kernel path and on the plain path (outputs and grads,
    TRAIN_TOL fp32), and the band path: masked_flash_attention over
    BAND_PATH_SPARSE's make_block_mask at a walk of BAND_PATH_WALK, once,
    which runs K1-K3's band arity. Returns the launches of K8-K10 and of
    the band arity."""
    import torch
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseSelfAttention, blocksparse_v2, sparsity_config_from_dict)
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        planned_kernel
    from deepspeed_tpu_torch.runtime.config import get_sparse_attention
    rng = np.random.RandomState(SEED + 12)
    m = V2_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    with open(SPARSE_DS_CONFIG) as f:
        ds_config = json.load(f)
    sa = get_sparse_attention(ds_config)

    def inputs(heads, dtype):
        q, k, v, g = train_inputs(rng, B, heads, heads, S, D, dtype)
        return [t.requires_grad_() for t in (q, k, v)], g

    lengths = rng.randint(SPARSE_MIN_LEN, S + 1, size=B)
    keep = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None]
                             ).astype(np.float32)).cuda()
    am = v2_mask(rng, S)
    ssa = SparseSelfAttention(sparsity_config_from_dict(sa, num_heads=H),
                              key_padding_mask_mode="mul")
    qkv, g = inputs(H, torch.bfloat16)

    def call(module, qkv, g):
        o = module(*qkv, key_padding_mask=keep, attn_mask=am)
        (o.float() * g.float()).sum().backward()
        return o

    for _ in range(V2_WARMUP):
        call(ssa, qkv, g)
    torch.cuda.synchronize()
    for t in qkv:
        t.grad = None
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    t0 = time.perf_counter()
    for _ in range(V2_ITERS):
        o = call(ssa, qkv, g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _v2_launches()
    k1_k3 = _train_launches()
    bodies = _mma_bodies(V2_NAMES)
    layout = ssa.get_layout(S)
    row = {"phase": "sparse_self_attention",
           "entry": "SparseSelfAttention(sparsity_config_from_dict("
                    "ds_config_sparse.json), key_padding_mask_mode='mul')"
                    "(q, k, v, key_padding_mask, attn_mask)",
           "sparse_attention": sa, "shape": dict(m, dtype="bf16"),
           "route": planned_kernel(layout, 16, has_am=True),
           "attn_mask": f"'mul', keeps {V2_KEEP}",
           "real_lengths": f"{SPARSE_MIN_LEN}-{S}",
           "iters": V2_ITERS, "warmup": V2_WARMUP,
           "ms_per_fwd_bwd": wall / V2_ITERS * 1e3,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "k1_k3_launches": k1_k3,
           "launches_by_body": bodies, "nvidia_smi": smi}
    finite = bool(torch.isfinite(o).all()) and all(
        t.grad is not None and bool(torch.isfinite(t.grad).all())
        for t in qkv)
    row["finite"] = finite
    emit(row)
    if not finite:
        raise AssertionError(f"non-finite outputs or grads: {row}")
    if any(n != V2_ITERS for n in launches.values()) or any(k1_k3.values()):
        raise AssertionError(f"want {V2_ITERS} launches of each of K8-K10 "
                             f"and none of K1-K3: {row}")
    _check_mma_bodies(row["phase"], bodies)
    del qkv, g, o

    # the kernel path against the plain path: 2 heads, fp32
    ssa2 = SparseSelfAttention(sparsity_config_from_dict(sa, num_heads=2),
                               key_padding_mask_mode="mul")
    qkv, g = inputs(2, torch.float32)
    results = {}
    for path in ("kernel", "plain"):
        for t in qkv:
            t.grad = None
        before = _v2_launches()["blocksparse_v2_fwd"]
        with (_PlainRowRun() if path == "plain"
              else contextlib.nullcontext()):
            o = call(ssa2, qkv, g)
        ran_kernel = _v2_launches()["blocksparse_v2_fwd"] > before
        if ran_kernel != (path == "kernel"):
            raise AssertionError(f"the {path} path ran the kernel: "
                                 f"{ran_kernel}")
        results[path] = [o.detach()] + [t.grad.clone() for t in qkv]
    tol = TRAIN_TOL["fp32"]
    cmp = {key: compare(a, b, **tol) for key, a, b in
           zip(("o", "dq", "dk", "dv"), results["kernel"],
               results["plain"])}
    row = {"phase": "sparse_self_attention_kernel_vs_plain", "heads": 2,
           "dtype": "fp32", "tol": tol,
           **{f"{key}_worst_ratio": c[0] for key, c in cmp.items()},
           **{f"{key}_max_abs_err": c[2] for key, c in cmp.items()},
           "ok": all(c[3] for c in cmp.values())}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"SparseSelfAttention's kernel path differs "
                             f"from its plain path: {row}")
    del qkv, g, o, results

    # the band path: K1-K3's band arity over the config's mask at a walk
    # of 128, asked for through make_block_mask (the walk rule keeps the
    # fine walk: K1-K3 pay per computed cell, masked_flash.WALK_COSTS)
    ds_band = dict(ds_config, sparse_attention=BAND_PATH_SPARSE)
    band = sparsity_config_from_dict(get_sparse_attention(ds_band),
                                     num_heads=H)
    mask = band.make_block_mask(S, walk_block=BAND_PATH_WALK)
    qkv, g = inputs(H, torch.bfloat16)
    mf.reset_launches()
    o = mf.masked_flash_attention(
        *qkv, mask, key_mask=torch.where(keep == 0, -1e30, 0.0))
    (o.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    arities = {n: dict(getattr(mf, n).arities) for n in KPM_NAMES}
    band_launches = {n: a.get(BAND_PATH_ARITY, 0) for n, a in
                     arities.items()}
    row = {"phase": "sparse_self_attention_band",
           "sparse_attention": BAND_PATH_SPARSE,
           "entry": f"masked_flash_attention(q, k, v, sparsity_config."
                    f"make_block_mask({S}, walk_block={BAND_PATH_WALK}), "
                    f"key_mask)",
           "rule_route": planned_kernel(band.make_layout(S), 16),
           "launches_by_arity": arities, "nvidia_smi": smi}
    emit(row)
    if any(a != {BAND_PATH_ARITY: 1} for a in arities.values()) or \
            not bool(torch.isfinite(o).all()):
        raise AssertionError(f"the band path: want one launch of each of "
                             f"K1-K3 in {BAND_PATH_ARITY}: {row}")
    return launches, band_launches


# ------------------------------------------- the legacy sparse dispatch
# blocksparse.USE_MASKED_FLASH = False: the legacy dispatch JAX's
# sparse_attention_speedup_s8k row pins (bench.py:542-561), at its
# geometry (_sparse_row_geometry, bench.py:504-512): B 1, H 16, S 8192,
# D 64, bf16, fine block 128. "lf": BSLongformer with a window of 3 blocks
# (5024 active blocks, 7.7% dense), the banded kernels K11-K13; "bb":
# BigBird's defaults (5952 blocks), the hybrid: K11-K13 on the band and
# K8-K10 without a mask tile on the 928 residual blocks.
S8K_SHAPE = dict(B=1, H=16, S=8192, D=64, block=128)
BANDED_NAMES = ("banded_fwd", "banded_dq", "banded_dkv")
BANDED_REPLACES = {
    "banded_fwd": "deepspeed_tpu/ops/sparse_attention/banded.py:241 "
                  "(_fwd_body)",
    "banded_dq": "deepspeed_tpu/ops/sparse_attention/banded.py:280 "
                 "(_dq_body)",
    "banded_dkv": "deepspeed_tpu/ops/sparse_attention/banded.py:314 "
                  "(_dkv_body)"}
NOMASK_REPLACES = {n: r.replace("has_am", "has_am=False, the no-mask arity")
                   for n, r in V2_REPLACES.items()}
# launches of K11, K12 and K13 per attention call of a layout with global
# rows and columns: fwd and dq run the band and gr instances, dkv the
# band, gc and gr ones
BANDED_PER_CALL = {"banded_fwd": 2, "banded_dq": 2, "banded_dkv": 3}
# JAX's test_geometry_parity (tests/unit/test_banded_attention.py:198)
BANDED_GEOMETRIES = [(1, 1, 1, False), (2, 2, 2, True), (0, 0, 1, False),
                     (0, 0, 2, True), (3, 3, 1, False), (2, 0, 1, False),
                     (0, 2, 1, True), (1, 1, 0, True)]
BANDED_SWEEP = ((32, 32), (64, 64), (128, 128), (64, 128), (128, 64))
# The split walks at forced splits, bf16 at S 512 (B 2, H 4, D 64): (name,
# fine block, geometry, tiles, kv tiles per split of K11's and K12's gr
# walks, q tiles per split of K13's gc walk, a key mask with a batch row
# of pads or none)
BANDED_SPLIT_CASES = [
    ("one_tile_per_split", 32, (1, 1, 1, False), (64, 64), 1, 1, True),
    ("uneven_last_split", 32, (1, 1, 1, False), (32, 32), 3, 5, False),
    ("causal_gr", 32, (3, 3, 1, True), (64, 32), 2, 3, True),
    ("g_r_wider_than_a_tile", 16, (6, 2, 1, False), (64, 32), 5, 2, False),
    ("one_warp_a_cta", 16, (2, 1, 1, False), (16, 16), 4, 7, True)]
# K11-K13 on their former CUDA-core bodies in bf16 at the s8k geometry
# (PERF.md section 6; these timing phases on an NVIDIA H100 80GB HBM3 at
# 700 W): ms per instance and summed, by layout, printed beside this run's
# in phase 26's rows
FORMER_BANDED = {
    "banded_fwd": {"lf": {"band": 2.30258, "gr": 5.76622, "ms": 8.06880},
                   "bb": {"ms": 8.08898}},
    "banded_dq": {"lf": {"band": 2.78848, "gr": 5.83379, "ms": 8.62227},
                  "bb": {"ms": 8.47062}},
    "banded_dkv": {"lf": {"band": 3.47158, "gc": 6.92750, "gr": 1.22008,
                          "ms": 11.61917},
                   "bb": {"ms": 11.14240}}}
# tiles per split of the split walks (K11's and K12's gr walks over kv
# tiles, K13's gc walk over q tiles) timed beside the plans', at the s8k
# geometry (64 kv tiles, 63 q tiles) and sparse BERT's (128, 127)
KPS_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128)
# the walk tiles of K11-K13 timed at sparse BERT's BSLongformer (block 16)
# beside BANDED_SWEEP's at s8k, for the walk-cost fit
BANDED_BERT_SWEEP = ((16, 16), (32, 32), (16, 32), (32, 16), (64, 64))


def s8k_config(kind, heads=16):
    """The SparsityConfig of the s8k row's layouts: "lf" or "bb"."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig)
    if kind == "lf":
        return BSLongformerSparsityConfig(num_heads=heads, block=128,
                                          num_sliding_window_blocks=3)
    return BigBirdSparsityConfig(num_heads=heads, block=128)


def _banded_launches():
    from deepspeed_tpu_torch.ops.sparse_attention import banded
    return {n: getattr(banded, n).launches for n in BANDED_NAMES}


def _reset_legacy_launches():
    from deepspeed_tpu_torch.ops.sparse_attention import (banded,
                                                          blocksparse_v2)
    banded.reset_launches()
    blocksparse_v2.reset_launches()


class _Legacy:
    """Within the block, block_sparse_attention runs the legacy dispatch
    (``blocksparse.USE_MASKED_FLASH = False``); the flag and the function
    cache are restored after."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.sparse_attention import blocksparse
        self._saved = blocksparse.USE_MASKED_FLASH
        blocksparse.USE_MASKED_FLASH = False
        blocksparse._FN_CACHE.clear()
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.sparse_attention import blocksparse
        blocksparse.USE_MASKED_FLASH = self._saved
        blocksparse._FN_CACHE.clear()
        return False


class _PlainBanded:
    """Within the block, the banded instances run the three kernels'
    plain versions instead of their wrappers."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.sparse_attention import banded
        self._saved = tuple(getattr(banded, n) for n in BANDED_NAMES)
        for n in BANDED_NAMES:
            setattr(banded, n, getattr(banded, n + "_plain"))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.sparse_attention import banded
        for n, fn in zip(BANDED_NAMES, self._saved):
            setattr(banded, n, fn)
        return False


class _NoPredicate:
    """Within the block, the plain versions keep every walked cell: the
    banded checks' control."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.sparse_attention.banded import \
            BandedPlan
        self._saved = BandedPlan.keep
        BandedPlan.keep = lambda self, pred, rb, cb: (rb >= 0) & (cb >= 0)
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.sparse_attention.banded import \
            BandedPlan
        BandedPlan.keep = self._saved
        return False


def check_banded_kernels(name, bp, args, key_mask, extra=None, kps=None,
                         qps=None):
    """K11, K12 and K13 against their plain versions on the same inputs,
    launch by launch: each instance of each kernel, the split walks in
    bf16 held to the plain versions split as the kernels split them
    (K11's and K12's gr instances: ``kps`` kv tiles a split, K13's gc
    instance: ``qps`` q tiles a split; None for fwd_split's and
    dkv_split's), the backward ones fed the plain forward's lse of their
    rows and delta of its combined output, under TRAIN_TOL (the worst
    instance per output); lse within LSE_ATOL. The combination of the
    instances is the same PyTorch on both sides. The control: the plain
    versions with the keep predicate dropped (every walked cell kept; the
    backward fed that forward's lses and delta) must fail the same check
    on every output. In bf16 the global rows of the kernel's split gr
    instance must also lie within SPLIT_TOL of the plain one walk's; each
    kernel must run the body of its dtype (body, dq_body, dkv_body); and
    K12's and K13's tensor-core bodies must sum again as many cells with
    their walks split as in one walk (their tallies): ds depends on p, dp
    and delta alone, which the split leaves as they were."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    bf16 = q.dtype == torch.bfloat16
    dtype = "bf16" if bf16 else "fp32"
    tol = TRAIN_TOL[dtype]
    splits = {kind: kps if kind == "gr" and kps else
              tb.fwd_split(q, bp, kind) for kind in bp.instances["row"]}
    forced = {"banded_dq": {"gr": kps}, "banded_dkv": {"gc": qps}}
    bwd_splits = {
        "banded_dq": {kind: kps if kind == "gr" and kps else
                      tb.fwd_split(q, bp, kind)
                      for kind in bp.instances["row"]},
        "banded_dkv": {kind: qps if kind == "gc" and qps else
                       tb.dkv_split(q, bp, kind)
                       for kind in bp.instances["col"]}}

    def plain_forward():
        """Each row instance's plain (o, lse), and the lses of each
        instance's rows and delta of the combined o, the backward's
        inputs."""
        fwd = {kind: tb.banded_fwd_plain(q, k, v, key_mask, bp, kind, scale,
                                         kv_tiles_per_split=splits[kind])
               for kind in bp.instances["row"]}
        o = fwd["band"][0]
        if "gr" in fwd:
            o = tb._add_rows(o, fwd["gr"][0])
        lses = {kind: lse for kind, (_, lse) in fwd.items()}
        lses["gc"] = lses["band"]
        return fwd, lses, (do.float() * o.float()).sum(-1)

    fwd_plain, lses, delta = plain_forward()
    with _NoPredicate():
        fwd_c, lses_c, delta_c = plain_forward()
    before = {n: dict(getattr(tb, n).bodies) for n in BANDED_NAMES}
    # output -> [(instance, kernel, plain, control)]
    outs = {"o": [], "dq": [], "dk": [], "dv": []}
    lse_err = 0.0
    one_walk = {}
    # re-summed cells by kernel and instance, and of the split walks
    # again in one walk
    resummed, resummed_one_walk = {}, {}

    def tallied(name, fn, kind, a, steps):
        """``fn``'s outputs for instance ``kind`` (its split forced where
        the case forces it) and, in bf16, the cells its body summed again,
        also with the walk in one split where it splits."""
        arg = ("kv_tiles_per_split" if name == "banded_dq"
               else "q_tiles_per_split")
        tally = torch.zeros(1, dtype=torch.int64, device=q.device) \
            if bf16 else None
        out = fn(*a, **{arg: forced[name].get(kind)}, tally=tally)
        if bf16:
            resummed[f"{name} {kind}"] = int(tally.item())
            if (bwd_splits[name][kind] or steps) < steps:
                one = torch.zeros_like(tally)
                fn(*a, **{arg: steps}, tally=one)
                resummed_one_walk[f"{name} {kind}"] = int(one.item())
        return out

    for kind in bp.instances["row"]:
        o, lse = tb.banded_fwd(q, k, v, key_mask, bp, kind, scale,
                               kv_tiles_per_split=kps if kind == "gr"
                               else None)
        if splits[kind]:
            # the global rows alone (the instance's other rows keep nothing)
            rows = bp.params[0] * bp.fine_block
            want = tb.banded_fwd_plain(q, k, v, key_mask, bp, kind,
                                       scale)[0][:, :, :rows].float()
            diff = (o[:, :, :rows].float() - want).abs()
            bound = SPLIT_TOL["atol"] + SPLIT_TOL["rtol"] * (
                v.float().abs().max() + want.abs())
            one_walk = {"max_abs_err": float(diff.max()),
                        "worst_ratio": float((diff / bound).max()),
                        "rel_rms": float(diff.norm() /
                                         want.norm().clamp_min(1e-30))}
        a = (q, k, v, do, lses[kind], delta, key_mask, bp, kind, scale)
        dq = tallied("banded_dq", tb.banded_dq, kind, a,
                     bp.instances["row"][kind][1])
        torch.cuda.synchronize()
        lse_err = max(lse_err, float((lse - lses[kind]).abs().max()))
        with _NoPredicate():
            dq_c = tb.banded_dq_plain(q, k, v, do, lses_c[kind], delta_c,
                                      key_mask, bp, kind, scale)
        outs["o"].append((kind, o, fwd_plain[kind][0], fwd_c[kind][0]))
        outs["dq"].append((kind, dq, tb.banded_dq_plain(
            *a, bwd_splits["banded_dq"][kind]), dq_c))
    for kind in bp.instances["col"]:
        a = (q, k, v, do, lses[kind], delta, key_mask, bp, kind, scale)
        dk, dv = tallied("banded_dkv", tb.banded_dkv, kind, a,
                         bp.instances["col"][kind][1])
        torch.cuda.synchronize()
        dk_p, dv_p = tb.banded_dkv_plain(*a, bwd_splits["banded_dkv"][kind])
        with _NoPredicate():
            dk_c, dv_c = tb.banded_dkv_plain(q, k, v, do, lses_c[kind],
                                             delta_c, key_mask, bp, kind,
                                             scale)
        outs["dk"].append((kind, dk, dk_p, dk_c))
        outs["dv"].append((kind, dv, dv_p, dv_c))
    ran = {n: _body_ran(getattr(tb, n), before[n]) for n in BANDED_NAMES}
    row = {"phase": "banded_kernel_check", "case": name,
           "dtype": str(q.dtype), "shape": list(q.shape),
           "fine_block": bp.fine_block, "params": list(bp.params),
           "tiles": [bp.bq, bp.bkv],
           "instances": {w: sorted(i) for w, i in bp.instances.items()},
           "key_mask": key_mask is not None,
           "rows_with_no_key": int((lses["band"] <= tb.VALID_THRESH).sum()),
           "body": ran["banded_fwd"], "dq_body": ran["banded_dq"],
           "dkv_body": ran["banded_dkv"],
           "kv_tiles_per_split": splits.get("gr"),
           "gr_kv_tiles": bp.GRK,
           "dq_kv_tiles_per_split": bwd_splits["banded_dq"].get("gr"),
           "dkv_q_tiles_per_split": bwd_splits["banded_dkv"].get("gc"),
           "gc_q_tiles": bp.instances["col"].get("gc", (0, 0))[1],
           "gr_vs_one_walk": one_walk or None,
           "resummed_cells": resummed or None,
           "resummed_cells_one_walk": resummed_one_walk or None,
           "tol": tol, "lse_atol": LSE_ATOL, **(extra or {}),
           "control": "the keep predicate dropped: every walked cell kept"}
    ok = all(r == [kernel_body(n, dtype)] for n, r in ran.items())
    ok &= all(resummed[key] == n for key, n in resummed_one_walk.items())
    for key, items in outs.items():
        checks = [(kind, compare(out, ref, **tol)) for kind, out, ref, _
                  in items]
        controls = [compare(c, ref, **tol) for _, _, ref, c in items]
        row[f"{key}_max_abs_err"] = max(c[2] for _, c in checks)
        row[f"{key}_worst_ratio"] = max(c[0] for _, c in checks)
        row[f"{key}_rel_rms"] = max(c[1] for _, c in checks)
        row[f"{key}_worst_ratio_by_instance"] = {kind: c[0]
                                                 for kind, c in checks}
        ok &= all(c[3] for _, c in checks)
        row[f"control_{key}_worst_ratio"] = max(c[0] for c in controls)
        row[f"control_{key}_fails"] = not all(c[3] for c in controls)
        ok &= row[f"control_{key}_fails"]
    row["lse_max_abs_err"] = lse_err
    ok &= lse_err <= LSE_ATOL
    ok &= not one_walk or (one_walk["worst_ratio"] <= 1.0 and
                           one_walk["rel_rms"] <= SPLIT_TOL["rms"])
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"the banded kernels disagree with their plain "
                             f"versions on {name}, ran another body, or the "
                             f"control passes the check: {row}")
    return row


def _banded_plan(layout, block, cpu=False):
    """The BandedPlan the legacy dispatch builds for ``layout``: the exact
    banded path's, or the hybrid's band."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded, hybrid
    planned = banded.plan(layout, block, cpu)
    if planned is None:
        hp = hybrid.plan_hybrid(layout, block, cpu)
        planned = (hp.params, hp.blocks)
    H, nb, _ = layout.shape
    return banded.BandedPlan(H, nb * block, block, planned[0], *planned[1])


def banded_kernel_check_phase():
    """Phase 24: K11-K13 against their plain versions on the card: the
    s8k BSLongformer layout at the rule's tiles; sparse BERT's
    BSLongformer (B 8, H 16, S 2048, block 16) with its key mask (lengths
    1024-2048, -1e30 on the pads); JAX's eight geometries at S 512, fine
    block 32, at tiles (64, 128) and (128, 64) (wider than the fine
    block), bf16 and fp32, with a batch row of pads; K11's gr walk at the
    forced splits of BANDED_SPLIT_CASES. Returns the s8k and the BERT
    rows."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import NEG_INF
    rng = np.random.RandomState(SEED + 13)
    m = S8K_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    bf16 = torch.bfloat16
    main_row = check_banded_kernels(
        "s8k_bslongformer_w3_bf16",
        _banded_plan(s8k_config("lf", H).make_layout(S), m["block"]),
        train_inputs(rng, B, H, H, S, D, bf16), None)
    sc = sparse_config("bslongformer")
    m = SPARSE_SHAPE
    bert_row = check_banded_kernels(
        "bert_large_s2048_bslongformer_kpm",
        _banded_plan(sc.make_layout(m["S"]), sc.block),
        train_inputs(rng, m["B"], m["H"], m["H"], m["S"], m["D"], bf16),
        bert_key_mask(rng, m["B"], m["S"], SPARSE_MIN_LEN, pad=NEG_INF))
    for i, geom in enumerate(BANDED_GEOMETRIES):
        tiles = ((64, 128), (128, 64))[i % 2]
        dtype = (bf16, torch.float32)[(i // 2) % 2]
        pads = (1,) if i % 3 == 0 else ()
        check_banded_kernels(
            "geometry_g{}_{}_w{}{}_tiles{}x{}_{}".format(
                *geom[:3], "_causal" if geom[3] else "", *tiles,
                "fp32" if dtype == torch.float32 else "bf16"),
            tb.BandedPlan(4, 512, 32, tb.BandedParams(*geom), *tiles),
            train_inputs(rng, 2, 4, 4, 512, 64, dtype),
            bert_key_mask(rng, 2, 512, 200, all_pad_rows=pads, pad=NEG_INF),
            extra={"all_pad_rows": list(pads)})
    for case, fb, geom, tiles, kps, qps, kpm in BANDED_SPLIT_CASES:
        check_banded_kernels(
            f"split_{case}_kps{kps}_qps{qps}_bf16",
            tb.BandedPlan(4, 512, fb, tb.BandedParams(*geom), *tiles),
            train_inputs(rng, 2, 4, 4, 512, 64, bf16),
            bert_key_mask(rng, 2, 512, 200, all_pad_rows=(1,), pad=NEG_INF)
            if kpm else None, kps=kps, qps=qps,
            extra={"all_pad_rows": [1] if kpm else []})
    return main_row, bert_row


def v2_nomask_kernel_check_phase():
    """Phase 25: K8, K9 and K10 without a mask tile against their plain
    versions on the card: the hybrid's residue of the s8k BigBird layout
    (928 blocks of 128, the fine walk), and the fixed per-head layouts of
    ds_config_sparse.json at S 2048 with the key mask, at the fine walk
    and at a forced coarse walk of 64 (its structural tiles, bf16
    values). Returns the residue's row."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import hybrid
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import NEG_INF
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse_v2 import \
        RowRunPlan
    rng = np.random.RandomState(SEED + 14)
    m = S8K_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    bf16 = torch.bfloat16
    hp = hybrid.plan_hybrid(s8k_config("bb", H).make_layout(S), m["block"],
                            False)
    main_row = check_v2_kernels(
        "s8k_bigbird_residual_bf16",
        RowRunPlan(hp.residual, m["block"], None, per_coord=False),
        train_inputs(rng, B, H, H, S, D, bf16), None, None,
        phase="v2_nomask_kernel_check",
        extra={"residual_blocks": int(hp.residual.sum())})
    m = V2_SHAPE
    layout = sparse_config("fixed", heads=m["H"]).make_layout(m["S"])
    args = train_inputs(rng, m["B"], m["H"], m["H"], m["S"], m["D"], bf16)
    kpm = bert_key_mask(rng, m["B"], m["S"], SPARSE_MIN_LEN, pad=NEG_INF)
    for walk in (None, 64):
        check_v2_kernels(
            f"bert_large_s2048_fixed_nomask_walk{walk or 16}",
            RowRunPlan(layout, 16, walk, per_coord=False), args, kpm, None,
            phase="v2_nomask_kernel_check")
    return main_row


def _banded_timing(bp, args, key_mask, flush, plain=True):
    """Per kernel of K11-K13: the median ms of each instance (as
    train_kernel_timing times, the L2 flushed) summed over the instances,
    and with ``plain`` one timed call of each instance's plain version,
    summed."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    o, lse_b, lse_g = tb.banded_fwd_impl(q, k, v, key_mask, bp, scale)
    delta = (do.float() * o.float()).sum(-1)
    lses = {"band": lse_b, "gc": lse_b, "gr": lse_g}
    calls = []
    for kind in bp.instances["row"]:
        a = (q, k, v, do, lses[kind], delta, key_mask, bp, kind, scale)
        calls += [("banded_fwd", kind, tb.banded_fwd, tb.banded_fwd_plain,
                   (q, k, v, key_mask, bp, kind, scale)),
                  ("banded_dq", kind, tb.banded_dq, tb.banded_dq_plain, a)]
    for kind in bp.instances["col"]:
        a = (q, k, v, do, lses[kind], delta, key_mask, bp, kind, scale)
        calls.append(("banded_dkv", kind, tb.banded_dkv, tb.banded_dkv_plain,
                      a))
    out = {n: {"ms": 0.0, "plain_ms": 0.0 if plain else None,
               "instances": {}} for n in BANDED_NAMES}
    for name, kind, fn, plain_fn, a in calls:
        ms = time_ms(lambda: fn(*a), SPARSE_TIMED_CALLS, flush)
        out[name]["ms"] += ms
        out[name]["instances"][kind] = ms
        if plain:
            out[name]["plain_ms"] += time_ms(lambda: plain_fn(*a), 1, flush,
                                             warmup=0)
    return out


def _bounds(flops, b_in, b_out, bytes_per_s, flops_per_s):
    bytes_ms = (b_in + b_out) / bytes_per_s * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return {"bytes": b_in + b_out, "flops": flops, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def legacy_sparse_timing_phase(smi):
    """Phase 26: at the s8k geometry, for the BSLongformer (banded) and
    the BigBird (hybrid) layouts, K11, K12 and K13 per instance and
    summed, timed as train_kernel_timing times them, each beside its
    bound (the bytes moved once, or the FLOP of the layout's banded part
    at the dense bf16 peak), one timed call of its plain version, SDPA
    with the dense float (B, H, S, S) mask of the layout (forward for K11,
    backward for K12 and K13 together: the library column), SDPA with
    is_causal=True (the dense baseline of JAX's row) and K1-K3 on the
    masked route at the same layout (the twin row sparse_attn_speedup_v2,
    bench.py:836). For BigBird also K8-K10 without a mask tile on the
    residue and the merge. Then a sweep of walk tiles at BSLongformer,
    fitted to the cost model (walk_cost_fit, kernels "banded"). Returns
    the timings of K11-K13 at BSLongformer and of the no-mask K8-K10 at
    BigBird."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    from deepspeed_tpu_torch.ops.sparse_attention import (
        banded, blocksparse_v2 as v2, hybrid)
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import NEG_INF
    rng = np.random.RandomState(SEED + 15)
    m = S8K_SHAPE
    B, H, S, D, fb = m["B"], m["H"], m["S"], m["D"], m["block"]
    args = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(D))
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    tile = B * H * S * D * 2
    rowvec = B * H * S * 4
    io = {  # name: (dots per cell pair, bytes in, bytes out)
        "fwd": (2, 3 * tile, tile + rowvec),
        "dq": (3, 4 * tile + 2 * rowvec, tile),
        "dkv": (4, 4 * tile + 2 * rowvec, 2 * tile)}

    def sdpa(mask=None, causal=False):
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             is_causal=causal)
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal), SPARSE_TIMED_CALLS,
            flush)
        bwd = time_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), SPARSE_TIMED_CALLS,
            flush)
        return {"fwd": fwd, "bwd": bwd}

    causal = sdpa(causal=True)
    results, out = {}, {}
    for kind in ("lf", "bb"):
        layout = s8k_config(kind, H).make_layout(S)
        blocks = torch.from_numpy(layout).cuda().bool()
        dense = torch.where(blocks.repeat_interleave(fb, 1)
                            .repeat_interleave(fb, 2), 0.0, NEG_INF).to(
            torch.bfloat16)[None]
        lib = sdpa(dense)
        del dense, blocks
        bm = BlockMask.from_layout(layout, fb)
        o_m, lse_m = mf.masked_flash_fwd(q, k, v, bm, scale)
        delta = (do.float() * o_m.float()).sum(-1)
        masked = {
            "masked_flash_fwd": time_ms(lambda: mf.masked_flash_fwd(
                q, k, v, bm, scale), SPARSE_TIMED_CALLS, flush),
            "masked_flash_dq": time_ms(lambda: mf.masked_flash_dq(
                q, k, v, do, lse_m, delta, bm, scale), SPARSE_TIMED_CALLS,
                flush),
            "masked_flash_dkv": time_ms(lambda: mf.masked_flash_dkv(
                q, k, v, do, lse_m, delta, bm, scale), SPARSE_TIMED_CALLS,
                flush)}
        bp = _banded_plan(layout, fb)
        timing = _banded_timing(bp, args, None, flush)
        hp = hybrid.plan_hybrid(layout, fb, False)
        # the layout's blocks the banded kernels own
        band_blocks = int(layout.sum()) - (0 if hp is None
                                           else int(hp.residual.sum()))
        meta = bp.bstart.nbytes + bp.bend.nbytes
        for name in BANDED_NAMES:
            dots, b_in, b_out = io[name.split("_")[1]]
            t = timing[name]
            t.update(_bounds(band_blocks * B * dots * 2 * fb * fb * D,
                             b_in + meta, b_out, bytes_per_s, flops_per_s))
            t["library_ms"] = lib["fwd" if name == "banded_fwd" else "bwd"]
            t["replaces"] = BANDED_REPLACES[name]
            t["fma_body_ms"] = FORMER_BANDED[name][kind]
            if name == "banded_dkv":
                t["q_tiles_per_split"] = banded.dkv_split(q, bp, "gc")
                t["gc_q_tiles"] = bp.instances["col"].get("gc", (0, 0))[1]
            else:
                t["kv_tiles_per_split"] = (
                    banded.fwd_split if name == "banded_fwd"
                    else banded.fwd_split)(q, bp, "gr")
                t["gr_kv_tiles"] = bp.GRK
            emit({"phase": "legacy_sparse_timing", "kernel": name,
                  "layout": kind, "shape": dict(m, dtype="bf16"),
                  "tiles": [bp.bq, bp.bkv], "params": list(bp.params),
                  "banded_blocks": band_blocks,
                  "layout_blocks": int(layout.sum()),
                  "kernel_ms": t["ms"], **t,
                  "body": kernel_body(name),
                  "library": "scaled_dot_product_attention "
                             + ("forward" if name == "banded_fwd" else
                                "backward (dq, dk, dv together)")
                             + ", dense float (B, H, S, S) mask",
                  "sdpa_causal_ms": causal["fwd" if name == "banded_fwd"
                                           else "bwd"],
                  "masked_route_ms": masked[name.replace("banded",
                                                         "masked_flash")],
                  "achieved_tflop_per_s": t["flops"] / t["ms"] / 1e9,
                  "nvidia_smi": smi})
        results[kind] = {"banded": timing, "lib": lib, "masked": masked}
        if kind == "lf":
            out.update(timing)
            continue
        # the hybrid's residue on K8-K10 without a mask tile, and the merge
        rp = v2.RowRunPlan(hp.residual, fb, None, per_coord=False)
        v2.reset_launches()
        o_r, lse_r = v2.blocksparse_v2_fwd(q, k, v, None, None, rp, scale)
        o_b, lse_b, lse_g = banded.banded_fwd_impl(q, k, v, None, bp, scale)
        merge_ms = time_ms(lambda: hybrid.merge(o_b, lse_b, lse_g, o_r,
                                                lse_r), SPARSE_TIMED_CALLS,
                           flush)
        o_h, L = hybrid.merge(o_b, lse_b, lse_g, o_r, lse_r)
        delta = (do.float() * o_h.float()).sum(-1)
        bwd = (q, k, v, do, L, delta, None, None, rp, scale)
        specs = {"blocksparse_v2_fwd": (
            lambda: v2.blocksparse_v2_fwd(q, k, v, None, None, rp, scale),
            lambda: v2.blocksparse_v2_fwd_plain(q, k, v, None, None, rp,
                                                scale)),
            "blocksparse_v2_dq": (lambda: v2.blocksparse_v2_dq(*bwd),
                                  lambda: v2.blocksparse_v2_dq_plain(*bwd)),
            "blocksparse_v2_dkv": (lambda: v2.blocksparse_v2_dkv(*bwd),
                                   lambda: v2.blocksparse_v2_dkv_plain(*bwd))}
        res_blocks = int(hp.residual.sum())
        for name, (call, plain) in specs.items():
            dots, b_in, b_out = io[name.split("_")[2]]
            walk = sum(a.nbytes for a in (rp.csc if name.endswith("dkv")
                                          else rp.csr))
            t = {"ms": time_ms(call, SPARSE_TIMED_CALLS, flush),
                 "plain_ms": time_ms(plain, 1, flush, warmup=0),
                 "library_ms": lib["fwd" if name.endswith("fwd")
                                   else "bwd"],
                 "replaces": NOMASK_REPLACES[name],
                 "fma_body_ms": FMA_BODY_MS.get(
                     ("legacy_sparse_timing", name, "bb residue")),
                 **_bounds(res_blocks * B * dots * 2 * fb * fb * D,
                           b_in + walk, b_out, bytes_per_s, flops_per_s)}
            emit({"phase": "legacy_sparse_timing", "kernel": name,
                  "arity": "no mask tile", "layout": "bb residue",
                  "body": kernel_body(name),
                  "shape": dict(m, dtype="bf16"),
                  "residual_blocks": res_blocks, "kernel_ms": t["ms"], **t,
                  "library": "scaled_dot_product_attention with the whole "
                             "BigBird layout's dense float mask",
                  "nvidia_smi": smi})
            out[f"{name}_nomask"] = t
        _check_mma_bodies("legacy_sparse_timing", _mma_bodies(V2_NAMES))
        emit({"phase": "legacy_sparse_timing", "kernel": "hybrid merge",
              "layout": kind, "ms": merge_ms,
              "coverage": hp.coverage, "nvidia_smi": smi})
    sweeps = split_sweeps(smi, args, flush)
    out["split_sweeps"] = sweeps
    out["walk_tiles"] = walk_tile_sweep(smi, args, flush)
    return out


def _bert_banded_case(rng):
    """Sparse BERT's BSLongformer at phase 19's shape (B 8, H 16, S 2048,
    D 64, block 16), bf16: its layout, block, inputs and key mask."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import NEG_INF
    sc, sm = sparse_config("bslongformer"), SPARSE_SHAPE
    return (sc.make_layout(sm["S"]), sc.block,
            train_inputs(rng, sm["B"], sm["H"], sm["H"], sm["S"], sm["D"],
                         torch.bfloat16),
            bert_key_mask(rng, sm["B"], sm["S"], SPARSE_MIN_LEN, pad=NEG_INF))


def walk_tile_sweep(smi, s8k_args, flush):
    """The end of phase 26: K11-K13 together (every instance, as
    train_kernel_timing times) at the walk tiles of BANDED_SWEEP on the
    s8k BSLongformer layout and of BANDED_BERT_SWEEP on sparse BERT's
    (with its key mask), each shape's rule tiles (banded.pick_blocks) timed
    first and again last (the spread of one point), fitted to walk_cost_us
    (kernels "banded") over both sweeps; the refit's picks, timed where
    the sweep did not reach them. Returns {shape: {tiles: ms}}."""
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import banded
    rng = np.random.RandomState(SEED + 22)
    m = S8K_SHAPE
    shapes = {"s8k bslongformer": (
        s8k_config("lf", m["H"]).make_layout(m["S"]), m["block"], s8k_args,
        None, BANDED_SWEEP),
        "sparse bert bslongformer": (*_bert_banded_case(rng),
                                     BANDED_BERT_SWEEP)}

    def total_ms(layout, fb, args, kpm, tiles):
        H, nb, _ = layout.shape
        bp = banded.BandedPlan(H, nb * fb, fb, banded.detect_banded(layout),
                               *tiles)
        t = _banded_timing(bp, args, kpm, flush, plain=False)
        return sum(t[n]["ms"] for n in BANDED_NAMES), t

    sweep, measured, rules, repeat = [], {}, {}, {}
    for label, (layout, fb, args, kpm, pairs) in shapes.items():
        B, H, S = args[0].shape[:3]
        params = banded.detect_banded(layout)
        rules[label] = banded.pick_blocks(S, fb, params, False)
        measured[label] = {}
        for tiles in dict.fromkeys((rules[label], *pairs)):
            total, t = total_ms(layout, fb, args, kpm, tiles)
            measured[label][tiles] = total
            sweep.append((*banded.walk_counts(S, fb, params, *tiles),
                          total / (B * H)))
            emit({"phase": "legacy_sparse_timing", "kernel": "K11-K13 sweep",
                  "layout": label, "tiles": list(tiles),
                  "ms": {n: t[n]["ms"] for n in BANDED_NAMES},
                  "total_ms": total,
                  "modeled_us_per_bh": banded.walk_cost(S, fb, params,
                                                        *tiles),
                  "rule_tiles": list(rules[label]), "nvidia_smi": smi})
        repeat[label] = total_ms(layout, fb, args, kpm, rules[label])[0]
    fit = fit_walk_costs(sweep)
    committed = mf.WALK_COSTS["banded"]
    picks = {}
    try:
        mf.WALK_COSTS["banded"] = tuple(fit)
        for label, (layout, fb, args, *_) in shapes.items():
            picks[label] = banded.pick_blocks(
                args[0].shape[2], fb, banded.detect_banded(layout), False)
    finally:
        mf.WALK_COSTS["banded"] = committed
    compared = {}
    for label, (layout, fb, args, kpm, _) in shapes.items():
        got = measured[label]
        if picks[label] not in got:
            got[picks[label]] = total_ms(layout, fb, args, kpm,
                                         picks[label])[0]
        rule_ms = got[rules[label]]
        compared[label] = {
            "rule_tiles": list(rules[label]), "rule_ms": rule_ms,
            "rule_ms_again": repeat[label],
            "spread": abs(repeat[label] - rule_ms) / min(repeat[label],
                                                         rule_ms),
            "refit_tiles": list(picks[label]),
            "refit_ms": got[picks[label]],
            "refit_gain": rule_ms / got[picks[label]] - 1.0,
            "ms_by_tiles": {f"{a}x{b}": x for (a, b), x in got.items()}}
    emit({"phase": "walk_cost_fit", "kernels": "banded",
          "layout": "s8k and sparse bert bslongformer", "sweep": [
              dict(zip(("tiles", "chunks", "chunk", "ms"), w))
              for w in sweep],
          "units": "per (batch, head); fit in us per tile, chunk, cell",
          "fit": fit, "committed": list(committed), "picks": compared,
          "nvidia_smi": smi})
    return measured


def split_sweeps(smi, s8k_args, flush):
    """The end of phase 26: the split walks timed (as train_kernel_timing
    times) at the tiles per split of KPS_SWEEP and at their plans', at
    the s8k BSLongformer geometry (``s8k_args``, no key mask) and at sparse
    BERT's (B 8, H 16, S 2048, block 16, its key mask), each beside the
    one walk (every tile in one split): K11's and K12's gr instances over
    their kv tiles (gr_split_plan), K13's gc instance over its q tiles
    (dkv_split). Returns {kernel: {shape: {tiles per split: ms}}}."""
    from deepspeed_tpu_torch.ops.sparse_attention import banded as tb
    rng = np.random.RandomState(SEED + 21)
    m = S8K_SHAPE
    layout, block, bert_args, bert_kpm = _bert_banded_case(rng)
    shapes = {
        "s8k bslongformer": (
            _banded_plan(s8k_config("lf", m["H"]).make_layout(m["S"]),
                         m["block"]), s8k_args, None),
        "sparse bert bslongformer": (_banded_plan(layout, block), bert_args,
                                     bert_kpm)}
    result = {n: {} for n in BANDED_NAMES}
    for label, (bp, args, kpm) in shapes.items():
        q, k, v, do = args
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
        o, lse_b, lse_g = tb.banded_fwd_impl(q, k, v, kpm, bp, scale)
        delta = (do.float() * o.float()).sum(-1)
        gr_rows = bp.GQ * bp.bq
        gt_rows = bp.GT * bp.bkv
        # kernel: (instance, its walk's tiles, plan, call at n a split,
        # the instance's rows, rows a CTA)
        walks = {
            "banded_fwd": ("gr", bp.GRK, tb.fwd_split(q, bp, "gr"),
                           lambda n: tb.banded_fwd(
                               q, k, v, kpm, bp, "gr", scale,
                               kv_tiles_per_split=n),
                           gr_rows, min(bp.bq, tb.MMA_ROWS)),
            "banded_dq": ("gr", bp.GRK, tb.fwd_split(q, bp, "gr"),
                          lambda n: tb.banded_dq(
                              q, k, v, do, lse_g, delta, kpm, bp, "gr",
                              scale, kv_tiles_per_split=n),
                          gr_rows, min(bp.bq, tb.MMA_ROWS)),
            "banded_dkv": ("gc", bp.instances["col"]["gc"][1],
                           tb.dkv_split(q, bp, "gc"),
                           lambda n: tb.banded_dkv(
                               q, k, v, do, lse_b, delta, kpm, bp, "gc",
                               scale, q_tiles_per_split=n),
                           gt_rows, min(bp.bkv, tb.MMA_ROWS))}
        for name, (kind, steps, rule, call, rows, cta) in walks.items():
            ms = {}
            for n in sorted({*(x for x in KPS_SWEEP if x <= steps), rule,
                             steps}):
                ms[n] = time_ms(lambda: call(n), SPARSE_TIMED_CALLS, flush)
            emit({"phase": "legacy_sparse_timing",
                  "kernel": f"{name} {kind} split sweep", "layout": label,
                  "shape": {"B": q.shape[0], "H": q.shape[1], "S": q.shape[2],
                            "D": q.shape[3], "block": bp.fine_block},
                  "tiles": [bp.bq, bp.bkv], "walk_tiles": steps,
                  "row_blocks": q.shape[0] * q.shape[1] * rows // cta,
                  "key_mask": kpm is not None,
                  "rule_tiles_per_split": rule,
                  "ms_by_tiles_per_split": ms, "one_walk_ms": ms[steps],
                  "rule_ms": ms[rule], "best": min(ms, key=ms.get),
                  "nvidia_smi": smi})
            result[name][label] = ms
    return result


def legacy_entry_point_phase(smi):
    """The end of phase 26: SparseSelfAttention at the s8k geometry,
    forward and backward of a scalar loss (1 warm-up, V2_ITERS timed),
    under the legacy dispatch and under the default one: ms, peak memory
    and launches per call. BSLongformer must launch BANDED_PER_CALL of
    K11-K13 per call under the legacy dispatch and nothing else; BigBird
    the same and one of each of K8-K10; the default launches K1-K3 once
    each. Returns the launches and the ms per call of the legacy runs."""
    import torch
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        planned_kernel
    rng = np.random.RandomState(SEED + 16)
    m = S8K_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    q, k, v, g = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    launches, ms = {}, {}
    for kind in ("lf", "bb"):
        ssa = SparseSelfAttention(s8k_config(kind, H))
        for legacy in (True, False):
            with (_Legacy() if legacy else contextlib.nullcontext()):
                route = planned_kernel(ssa.get_layout(S), m["block"])

                def call():
                    o = ssa(*qkv)
                    (o.float() * g.float()).sum().backward()
                    return o
                call()
                torch.cuda.synchronize()
                for t in qkv:
                    t.grad = None
                torch.cuda.reset_peak_memory_stats()
                _reset_legacy_launches()
                mf.reset_launches()
                t0 = time.perf_counter()
                for _ in range(V2_ITERS):
                    o = call()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = {**_banded_launches(), **_v2_launches(),
                   **_train_launches()}
            want = {n: 0 for n in got}
            if legacy:
                want.update({n: c * V2_ITERS
                             for n, c in BANDED_PER_CALL.items()})
                if kind == "bb":
                    want.update({n: V2_ITERS for n in V2_NAMES})
            else:
                want.update({n: V2_ITERS for n in KPM_NAMES})
            finite = bool(torch.isfinite(o).all()) and all(
                bool(torch.isfinite(t.grad).all()) for t in qkv)
            row = {"phase": "legacy_entry_point", "layout": kind,
                   "dispatch": "legacy" if legacy else "default",
                   "route": route, "shape": dict(m, dtype="bf16"),
                   "iters": V2_ITERS, "warmup": 1,
                   "ms_per_fwd_bwd": wall / V2_ITERS * 1e3,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "launches": got,
                   "launches_by_body": _mma_bodies((*V2_NAMES,
                                                    *BANDED_NAMES)),
                   "finite": finite, "nvidia_smi": smi}
            emit(row)
            if got != want or not finite:
                raise AssertionError(f"SparseSelfAttention at the s8k "
                                     f"geometry: want launches {want}: {row}")
            _check_mma_bodies(row["phase"], row["launches_by_body"])
            for t in qkv:
                t.grad = None
            if legacy:
                launches[kind] = got
                ms[kind] = row["ms_per_fwd_bwd"]
    return launches, ms


# ---------------------------------------- the legacy dense flash route
# set_attention_options(kernel="flash"): the per-path kernels K5 (forward),
# K6 (dq) and K7 (dk, dv). JAX's BENCH_LEGACY_ATTN=1 A/B (bench.py:3011)
# puts every dense attention of the GPT-2, Llama and BERT rows on them,
# causal attention with seq_q != seq_k runs them on every route, and
# sparse_attention_speedup_s8k (bench.py:546-590) times its dense side
# with them
FLASH_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")
FLASH_REPLACES = {
    "flash_fwd": "deepspeed_tpu/ops/attention/flash.py:280 (_fwd_kernel)",
    "flash_dq": "deepspeed_tpu/ops/attention/flash.py:361 (_bwd_dq_kernel)",
    "flash_dkv": "deepspeed_tpu/ops/attention/flash.py:429 "
                 "(_bwd_dkv_kernel)"}
# the LLAMA_1B geometry's attention: 32 q heads over 8 kv heads of 64
LLAMA_GQA_SHAPE = dict(B=2, H=32, Hkv=8, S=1024, D=64)
BERT_LEGACY_STEPS, BERT_LEGACY_WARMUP = 3, 1


def _flash_launches():
    from deepspeed_tpu_torch.ops.attention import flash as tf
    return {n: getattr(tf, n).launches for n in FLASH_NAMES}


def _reset_flash_launches():
    from deepspeed_tpu_torch.ops.attention import flash as tf
    tf.reset_launches()


class _FlashKnob:
    """Within the block, set_attention_options(kernel="flash"); the
    previous options are restored after."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.attention import set_attention_options
        self._saved = set_attention_options(kernel="flash")
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.attention import set_attention_options
        set_attention_options(kernel=self._saved.kernel)
        return False


class _PlainFlash:
    """Within the block, the flash autograd Function calls K5-K7's plain
    versions instead of their wrappers."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops.attention import flash as tf
        self._saved = tuple(getattr(tf, n) for n in FLASH_NAMES)
        for n in FLASH_NAMES:
            setattr(tf, n, getattr(tf, n + "_plain"))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.attention import flash as tf
        for n, fn in zip(FLASH_NAMES, self._saved):
            setattr(tf, n, fn)
        return False


class Route(NamedTuple):
    """An attention route as the training phases check it: the kernels it
    launches and how many times each one attention call launches them, a
    context in which they call their plain versions instead, the suffix
    of the phases' names ("" on the default route), what a profile calls
    them and their device function names, and the route
    ``blocksparse.planned_kernel`` must name for a sparse layout on it
    (None: not checked)."""
    per_call: dict
    plain: Callable[[], Any]
    suffix: str
    label: str
    profiled: tuple
    planned: Any = None

    def launches(self):
        """This route's kernels' launches, and every other attention
        kernel's."""
        every = _all_launches()
        return ({n: every[n] for n in self.per_call},
                {n: c for n, c in every.items() if n not in self.per_call})


def _all_launches():
    """The launches of every attention kernel of the port, by name."""
    return {**_train_launches(), **_flash_launches(), **_banded_launches(),
            **_v2_launches(), **_v1_launches()}


def _reset_all_launches():
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse
    _reset_train_launches()
    _reset_flash_launches()
    _reset_legacy_launches()
    blocksparse.reset_launches()


MASKED_ROUTE = Route(dict.fromkeys(KPM_NAMES, 1), _PlainMaskedFlash, "",
                     "K1-K3 (key-mask arity)",
                     ("mf_fwd_", "mf_dq_", "mf_dkv_"))
FLASH_ROUTE = Route(dict.fromkeys(FLASH_NAMES, 1), _PlainFlash, "_legacy",
                    "K5-K7 (key-mask arity)",
                    ("flash_fwd_", "flash_dq_", "flash_dkv_"))
BANDED_ROUTE = Route(BANDED_PER_CALL, _PlainBanded, "_legacy",
                     "K11-K13 (banded)",
                     ("banded_fwd_", "banded_dq_", "banded_dkv_"),
                     planned="banded")


def cross_inputs(rng, B, H, Hkv, sq, sk, D, dtype):
    """q, do (B, H, sq, D) and k, v (B, Hkv, sk, D) on the card, from
    numpy."""
    import torch
    arrs = [rng.randn(B, H, sq, D), rng.randn(B, Hkv, sk, D),
            rng.randn(B, Hkv, sk, D), rng.randn(B, H, sq, D)]
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for a in arrs]


def check_flash_kernels(name, args, causal, rate, key_mask=None,
                        control=None, seed=-123457, reference=False,
                        flush=None):
    """K5, K6 and K7 against their plain versions on the same inputs, at
    the card's tiles; the backward kernels get the plain forward's lse and
    delta, so each kernel is held against its own plain version. With
    causal seq_q < seq_k the keys no query reaches must get dk = dv = 0;
    with ``reference`` (fp32) o must also equal attention_reference.
    ``control``: what a plain version that has to fail the same check on
    every output leaves out: "rounding" (fp32 copies of the inputs: no
    rounding of p, pd and ds), "key mask" or "causal" (the clip). With
    ``flush`` each plain call is timed as it runs (:func:`timed_call`),
    under "plain_ms" in the returned row."""
    import torch
    from deepspeed_tpu_torch.ops.attention import flash as tf
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    sq, sk = q.shape[2], k.shape[2]
    blocks = tf._pick_blocks(sq, sk, q.device)
    bodies = dict(tf.flash_fwd.bodies)
    o, lse = tf.flash_fwd(q, k, v, causal, scale, rate, seed, key_mask)
    torch.cuda.synchronize()
    body = _body_ran(tf.flash_fwd, bodies)
    dq_bodies = dict(tf.flash_dq.bodies)
    dkv_bodies = dict(tf.flash_dkv.bodies)

    def plain(fn, *a):
        if flush is None:
            return fn(*a), None
        return timed_call(lambda: fn(*a), flush)
    (o_p, lse_p), fwd_ms = plain(tf.flash_fwd_plain, q, k, v, causal, scale,
                                 rate, seed, key_mask)
    delta = (do.float() * o_p.float()).sum(-1)
    bwd = (q, k, v, do, lse_p, delta, causal, scale, rate, seed, key_mask)
    dq = tf.flash_dq(*bwd)
    dk, dv = tf.flash_dkv(*bwd)
    torch.cuda.synchronize()
    dq_body = _body_ran(tf.flash_dq, dq_bodies)
    dkv_body = _body_ran(tf.flash_dkv, dkv_bodies)
    dq_p, dq_ms = plain(tf.flash_dq_plain, *bwd)
    (dk_p, dv_p), dkv_ms = plain(tf.flash_dkv_plain, *bwd)
    dtype = "fp32" if q.dtype == torch.float32 else "bf16"
    tol = TRAIN_TOL[dtype]
    row = {"phase": "flash_kernel_check", "case": name,
           "dtype": str(q.dtype), "shape_q": list(q.shape),
           "shape_kv": list(k.shape), "causal": causal,
           "body": body[0] if len(body) == 1 else body,
           "dq_body": dq_body[0] if len(dq_body) == 1 else dq_body,
           "dkv_body": dkv_body[0] if len(dkv_body) == 1 else dkv_body,
           "tiles": list(blocks), "dropout": rate,
           "key_mask": key_mask is not None, "tol": tol,
           "lse_atol": LSE_ATOL}
    if flush is not None:
        row["plain_ms"] = {"flash_fwd": fwd_ms, "flash_dq": dq_ms,
                           "flash_dkv": dkv_ms}
    if key_mask is not None:
        row["real_keys_per_row"] = [int(n) for n in
                                    (key_mask == 0).sum(-1).tolist()]
    refs = {"o": o_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    ok = True
    for key, out in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ratio, rel_rms, err, good = compare(out, refs[key], **tol)
        row[f"{key}_max_abs_err"] = err
        row[f"{key}_worst_ratio"] = ratio
        row[f"{key}_rel_rms"] = rel_rms
        ok &= good
    lse_err = float((lse - lse_p).abs().max())
    row["lse_max_abs_err"] = lse_err
    ok &= lse_err <= LSE_ATOL
    ok &= body == [kernel_body("flash_fwd", dtype)]
    ok &= dq_body == [kernel_body("flash_dq", dtype)]
    ok &= dkv_body == [kernel_body("flash_dkv", dtype)]
    if causal and sq < sk:
        zero = bool((dk[:, :, sq:] == 0).all() and (dv[:, :, sq:] == 0).all())
        row["unreached_keys_zero_grad"] = zero
        ok &= zero
    if reference:
        want = tf.attention_reference(
            q, k, v, mask=None if key_mask is None
            else key_mask[:, None, None, :], causal=causal)
        ratio, _, err, good = compare(o, want, **TRAIN_TOL["fp32"])
        row["o_vs_attention_reference"] = {"max_abs_err": err,
                                           "worst_ratio": ratio}
        ok &= good
    if control is not None:
        c_args, c_key, c_causal = args, key_mask, causal
        if control == "rounding":
            c_args = [t.float() for t in args]
        elif control == "key mask":
            c_key = None
        else:
            c_causal = False
        row["control"] = control + " left out"
        c_bwd = (*c_args, lse_p, delta, c_causal, scale, rate, seed, c_key)
        o_c, _ = tf.flash_fwd_plain(*c_args[:3], c_causal, scale, rate, seed,
                                    c_key)
        dq_c = tf.flash_dq_plain(*c_bwd)
        dk_c, dv_c = tf.flash_dkv_plain(*c_bwd)
        for key, out in (("o", o_c), ("dq", dq_c), ("dk", dk_c),
                         ("dv", dv_c)):
            ratio, rel_rms, _, good = compare(out.to(q.dtype), refs[key],
                                              **tol)
            row[f"control_{key}_worst_ratio"] = ratio
            row[f"control_{key}_rel_rms"] = rel_rms
            row[f"control_{key}_fails"] = not good
            ok &= not good
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions on {name}, or the control passes "
                             f"the check: {row}")
    return row


def flash_kernel_check_phase():
    """Phase 28. Returns the main-path case's row at dropout 0."""
    import torch
    bf16 = torch.bfloat16
    rng = np.random.RandomState(SEED + 20)
    m = MAIN_SHAPE
    main = train_inputs(rng, m["B"], m["H"], m["Hkv"], m["S"], m["D"], bf16)
    main_row = check_flash_kernels("gpt2_345m_causal_bf16", main, True, 0.0,
                                   control="rounding")
    check_flash_kernels("gpt2_345m_causal_bf16_dropout0.1", main, True, 0.1,
                        control="rounding")
    del main
    b = BERT_SHAPE
    check_flash_kernels(
        "bert_large_s128_key_mask_bf16",
        train_inputs(rng, b["B"], b["H"], b["Hkv"], b["S"], b["D"], bf16),
        False, 0.0, key_mask=bert_key_mask(rng, b["B"], b["S"], 64, (1,)),
        control="key mask")
    check_flash_kernels(
        "bert_large_s512_key_mask_bf16_dropout0.1",
        train_inputs(rng, 4, b["H"], b["Hkv"], 512, b["D"], bf16), False,
        0.1, key_mask=bert_key_mask(rng, 4, 512, 256, (2,)),
        control="key mask")
    g = LLAMA_GQA_SHAPE
    check_flash_kernels(
        "llama_1b_gqa_h32_hkv8_causal_bf16_dropout0.1",
        train_inputs(rng, g["B"], g["H"], g["Hkv"], g["S"], g["D"], bf16),
        True, 0.1, control="rounding")
    check_flash_kernels(
        "causal_sq512_sk1024_bf16_dropout0.1",
        cross_inputs(rng, 2, 16, 16, 512, 1024, 64, bf16), True, 0.1,
        control="causal")
    check_flash_kernels(
        "causal_sq1024_sk512_bf16",
        cross_inputs(rng, 2, 16, 16, 1024, 512, 64, bf16), True, 0.0,
        control="causal")
    check_flash_kernels(
        "causal_sq1024_sk512_gqa2_key_mask_fp32",
        cross_inputs(rng, 2, 4, 2, 1024, 512, 64, torch.float32), True, 0.0,
        key_mask=bert_key_mask(rng, 2, 512, 200), control="key mask",
        reference=True)
    check_flash_kernels(
        "full_fp32_seq96x160_hd24_dropout0.1",
        cross_inputs(rng, 2, 4, 4, 96, 160, 24, torch.float32), False, 0.1)
    # K5's and K7's tensor-core bodies: rectangular tiles (bq != bk) with
    # seq_q != seq_k, tiles of 16, head dims 32 to 128 (40 and 72 off the
    # mma's depth of 16), GQA, dropout and the key mask, each with its
    # control
    check_flash_kernels(
        "causal_sq320_sk1024_tiles64x128_bf16_dropout0.1",
        cross_inputs(rng, 2, 8, 8, 320, 1024, 64, bf16), True, 0.1,
        control="causal")
    check_flash_kernels(
        "full_sq1024_sk160_tiles128x32_hd40_gqa4_key_mask_bf16",
        cross_inputs(rng, 2, 8, 2, 1024, 160, 40, bf16), False, 0.0,
        key_mask=bert_key_mask(rng, 2, 160, 60), control="key mask")
    check_flash_kernels(
        "causal_s208_tiles16_hd32_bf16_dropout0.1",
        cross_inputs(rng, 2, 8, 8, 208, 208, 32, bf16), True, 0.1,
        control="rounding")
    check_flash_kernels(
        "full_seq96x160_tiles32_hd72_bf16",
        cross_inputs(rng, 2, 4, 4, 96, 160, 72, bf16), False, 0.0,
        control="rounding")
    check_flash_kernels(
        "causal_s512_hd128_gqa4_bf16_dropout0.1",
        cross_inputs(rng, 2, 16, 4, 512, 512, 128, bf16), True, 0.1,
        control="rounding")
    return main_row


def _walked_tiles(seq_q, seq_k, bq, bk, causal):
    """The tiles K5's walk visits per (batch, head)."""
    nk = seq_k // bk
    if not causal:
        return (seq_q // bq) * nk
    return sum(min(-(-(qb * bq + bq) // bk), nk) for qb in range(seq_q // bq))


def flash_kernel_timing_phase(smi, entry_ms):
    """Phase 29: K5, K6 and K7 at the GPT-2 training shape and at the s8k
    dense geometry (B 1, H 16, S 8192, D 64, bf16, causal), first held
    against their plain versions on the inputs they are timed on
    (:func:`check_flash_kernels`, the rounding control), then timed as
    train_kernel_timing times them, each beside its bound (bytes moved
    once, or the FLOP of the causal cells at the dense bf16 peak), the
    check's one timed call of its plain version, SDPA is_causal=True
    (forward for K5,
    backward for K6 and K7 together: the library column) and K1-K3 on the
    default route at the same shape. Then flash_attention(causal=True)
    forward and backward at the s8k geometry under kernel="flash" and
    under the default route (1 warm-up, V2_ITERS timed): ms, peak memory,
    launches per call, and the speedup of phase 26's legacy sparse calls
    over it (the dense side of sparse_attention_speedup_s8k). Returns the
    GPT-2 shape's timings, with the s8k ones under "s8k"."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import flash as tf
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                         pick_block)
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, m, calls in (("gpt2", MAIN_SHAPE, TIMED_CALLS),
                            ("s8k", S8K_SHAPE, SPARSE_TIMED_CALLS)):
        B, H, S, D = m["B"], m["H"], m["S"], m["D"]
        rng = np.random.RandomState(SEED + 21)
        q, k, v, do = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
        checked = check_flash_kernels(f"{label}_causal_bf16_timed",
                                      (q, k, v, do), True, 0.0,
                                      control="rounding", flush=flush)
        scale = 1.0 / float(np.sqrt(D))
        bq, bk = tf._pick_blocks(S, S, q.device)
        o, lse = tf.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        mask = BlockMask.causal(S, pick_block(S, S))
        o_m, lse_m = mf.masked_flash_fwd(q, k, v, mask, scale)
        delta_m = (do.float() * o_m.float()).sum(-1)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), calls, flush),
            "bwd": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do, retain_graph=True), calls,
                flush)}
        del sdpa_out, qs, ks, vs
        tile = B * H * S * D * 2
        rowvec = B * H * S * 4
        walked = _walked_tiles(S, S, bq, bk, True)
        bwd = (q, k, v, do, lse, delta, True, scale)
        bwd_m = (q, k, v, do, lse_m, delta_m, mask, scale)
        specs = {
            # name: (call, K1-K3's call, dots per cell, bytes in,
            #        bytes out, library ms)
            "flash_fwd": (lambda: tf.flash_fwd(q, k, v, True, scale),
                          lambda: mf.masked_flash_fwd(q, k, v, mask, scale),
                          2, 3 * tile, tile + rowvec, lib["fwd"]),
            "flash_dq": (lambda: tf.flash_dq(*bwd),
                         lambda: mf.masked_flash_dq(*bwd_m),
                         3, 4 * tile + 2 * rowvec, tile, lib["bwd"]),
            "flash_dkv": (lambda: tf.flash_dkv(*bwd),
                          lambda: mf.masked_flash_dkv(*bwd_m),
                          4, 4 * tile + 2 * rowvec, 2 * tile, lib["bwd"])}
        rows = {}
        # the causal cells' products: what causal attention needs, not the
        # masked-off half of each diagonal tile the walk visits
        cells = causal_cells(S, S)
        for name, (call, masked, dots, b_in, b_out, lib_ms) in \
                specs.items():
            t = {"ms": time_ms(call, calls, flush),
                 "plain_ms": checked["plain_ms"][name],
                 "library_ms": lib_ms,
                 "masked_route_ms": time_ms(masked, calls, flush),
                 "replaces": FLASH_REPLACES[name],
                 **_bounds(cells * B * H * dots * 2 * D, b_in, b_out,
                           bytes_per_s, flops_per_s)}
            emit({"phase": "flash_kernel_timing", "kernel": name,
                  "geometry": label, "shape": dict(m, dtype="bf16",
                                                   mask="causal"),
                  "fma_body_ms": FMA_BODY_MS.get(
                      ("flash_kernel_timing", name, label)),
                  "tiles": [bq, bk], "walked_tiles_per_bh": walked,
                  "causal_cells_per_bh": cells,
                  "kernel_ms": t["ms"], **t,
                  "library": "scaled_dot_product_attention is_causal=True "
                             + ("forward" if name == "flash_fwd" else
                                "backward (dq, dk, dv together)"),
                  "masked_route": f"K1-K3, BlockMask.causal walk "
                                  f"{mask.block}",
                  "body": kernel_body(name),
                  "achieved_tflop_per_s": t["flops"] / t["ms"] / 1e9,
                  "nvidia_smi": smi})
            rows[name] = t
        out[label] = rows
        del q, k, v, do, o, lse, delta, o_m, lse_m, delta_m
    out["gpt2"]["s8k"] = out["s8k"]
    # the dense side of sparse_attention_speedup_s8k, through the entry point
    m = S8K_SHAPE
    rng = np.random.RandomState(SEED + 22)
    q, k, v, g = train_inputs(rng, m["B"], m["H"], m["H"], m["S"], m["D"],
                              torch.bfloat16)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    dense = {}
    for route in ("flash", "masked"):
        with (_FlashKnob() if route == "flash" else contextlib.nullcontext()):
            def call():
                o = flash_attention(*qkv, causal=True)
                (o.float() * g.float()).sum().backward()
                return o
            call()
            torch.cuda.synchronize()
            for t in qkv:
                t.grad = None
            torch.cuda.reset_peak_memory_stats()
            _reset_flash_launches()
            mf.reset_launches()
            t0 = time.perf_counter()
            for _ in range(V2_ITERS):
                o = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = {**_flash_launches(), **_train_launches()}
        names = FLASH_NAMES if route == "flash" else KPM_NAMES
        want = {n: V2_ITERS if n in names else 0 for n in got}
        finite = bool(torch.isfinite(o).all()) and all(
            bool(torch.isfinite(t.grad).all()) for t in qkv)
        ms = wall / V2_ITERS * 1e3
        row = {"phase": "flash_s8k_entry_point", "route": route,
               "call": "flash_attention(q, k, v, causal=True), forward and "
                       "backward", "shape": dict(m, dtype="bf16"),
               "iters": V2_ITERS, "warmup": 1, "ms_per_fwd_bwd": ms,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "launches": got, "finite": finite, "nvidia_smi": smi}
        if route == "masked":
            dense["masked_launches"] = got["masked_flash_fwd"]
        if route == "flash":
            row["sparse_speedup_over_this"] = {
                f"{kind} legacy (phase 26)": ms / entry_ms[kind]
                for kind in sorted(entry_ms)}
            dense["ms_per_fwd_bwd"] = ms
            dense["peak_memory_bytes"] = row["peak_memory_bytes"]
        emit(row)
        if got != want or not finite:
            raise AssertionError(f"flash_attention at the s8k geometry: "
                                 f"want launches {want}: {row}")
        for t in qkv:
            t.grad = None
    out["gpt2"]["s8k_entry_point"] = dense
    return out["gpt2"]


# ---------------------------------------- the v1 block-sparse kernels
# blocksparse.USE_SPLASH_V2 = False: the per-triple kernels K14 (forward),
# K15 (dq) and K16 (dk, dv) on JAX's three paths to them: a user attention
# mask (JAX's oracle for K8-K10, tests/unit/test_sparse_attention.py:267),
# the legacy dispatch without a mask on a layout that is not banded
# (sparse BERT-large with ds_config_sparse.json as held: the key-mask
# arity) and the v1 fallback of the s8k row (bench.py:614-629: no mask,
# USE_BANDED = False)
V1_NAMES = ("bs_fwd", "bs_dq", "bs_dkv")
V1_REPLACES = {
    "bs_fwd": "deepspeed_tpu/ops/sparse_attention/blocksparse.py:181 "
              "(_bs_fwd_kernel)",
    "bs_dq": "deepspeed_tpu/ops/sparse_attention/blocksparse.py:226 "
             "(_bs_dq_kernel)",
    "bs_dkv": "deepspeed_tpu/ops/sparse_attention/blocksparse.py:261 "
              "(_bs_dkv_kernel)"}
# the row the (d) cases give keys at -5e28 only: v1's threshold (-1e28)
# zeros it, the row-run kernels' (-1e29) would not
V1_FAR_ROW, V1_FAR_VALUE = 77, -5e28


def _v1_launches():
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    return {n: getattr(bs, n).launches for n in V1_NAMES}


def _v1_arities():
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    return {n: dict(getattr(bs, n).arities) for n in V1_NAMES}


@contextlib.contextmanager
def _attrs(module, **values):
    """Within the block, ``module``'s attributes hold ``values``; the old
    ones are restored after."""
    saved = {n: getattr(module, n) for n in values}
    for n, value in values.items():
        setattr(module, n, value)
    try:
        yield
    finally:
        for n, value in saved.items():
            setattr(module, n, value)


def _v1_flags(**flags):
    """Within the block, ``blocksparse.USE_SPLASH_V2 = False`` and the
    flags in ``flags`` (e.g. ``USE_MASKED_FLASH=False``; the function
    cache keys on every flag)."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse
    return _attrs(blocksparse, USE_SPLASH_V2=False, **flags)


def _plain_triples():
    """Within the block, the v1 autograd Function calls K14-K16's plain
    versions instead of their wrappers."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse
    return _attrs(blocksparse, **{n: getattr(blocksparse, n + "_plain")
                                  for n in V1_NAMES})


def v1_plain_outputs(q, k, v, do, key_mask, am, plan, scale, plain=None):
    """o, lse, dq, dk, dv of the plain K14-K16 (K15 and K16 fed the plain
    forward's lse and delta); ``plain(kernel, fn, *args)`` runs each (by
    default, calls it)."""
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    plain = plain or (lambda _, fn, *a: fn(*a))
    o, lse = plain("bs_fwd", bs.bs_fwd_plain, q, k, v, key_mask, am, plan,
                   scale)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, key_mask, am, plan, scale)
    dq = plain("bs_dq", bs.bs_dq_plain, *bwd)
    dk, dv = plain("bs_dkv", bs.bs_dkv_plain, *bwd)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def check_v1_kernels(name, plan, args, key_mask, am, flush=None,
                     far_row=False, extra=None, rounding_control=False):
    """K14, K15 and K16 against their plain versions on the same inputs
    (K15 and K16 get the plain forward's lse and delta), under TRAIN_TOL;
    lse within LSE_ATOL; an empty block row's lse exactly NEG_INF in
    both; each kernel on the body its dtype runs ("body", "dq_body",
    "dkv_body"), K15's and K16's tensor-core bodies with the count of
    the cells they summed again ("resummed_cells", and their share of
    the walked cells). The controls, each of which must fail the same
    check on every output (K15 and K16 fed the control forward's lse and
    delta): the plain versions with the attention mask left out (where
    there is one), else with the key mask left out, else on fp32 copies
    of the inputs (no rounding of p and ds); with ``far_row`` also with
    the threshold set to the row-run kernels' -1e29. With
    ``rounding_control`` also the plain forward on fp32 copies (p not
    rounded to bf16) must fail it on o, and the plain backward on fp32
    copies (fed the same lse and delta: neither ds nor K16's p rounded to
    bf16) on dq and dk. With ``flush`` each plain call is timed once
    (:func:`timed_once`). Returns the row."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    q, k, v, do = args
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    plain_ms = {}

    def timed(kernel, fn, *a):
        if flush is None:
            return fn(*a)
        out, plain_ms[kernel] = timed_once(lambda: fn(*a), flush)
        return out

    refs = v1_plain_outputs(q, k, v, do, key_mask, am, plan, scale, timed)
    bs.reset_launches()
    o, lse = bs.bs_fwd(q, k, v, key_mask, am, plan, scale)
    bwd = (q, k, v, do, refs["lse"], (do.float() * refs["o"].float()).sum(-1),
           key_mask, am, plan, scale)
    tally = {n: torch.zeros(1, dtype=torch.int64, device=q.device)
             for n in ("bs_dq", "bs_dkv")}
    dq = bs.bs_dq(*bwd, tally=tally["bs_dq"])
    dk, dv = bs.bs_dkv(*bwd, tally=tally["bs_dkv"])
    torch.cuda.synchronize()
    arity = bs.v1_arity(key_mask, am)
    dtype = "fp32" if q.dtype == torch.float32 else "bf16"
    tol = TRAIN_TOL[dtype]
    bodies = {n: sorted(getattr(bs, n).bodies) for n in V1_NAMES}
    empty = [i for i, c in enumerate(np.diff(plan.rows[0]))
             if c == 1 and plan.rows[2][plan.rows[0][i]] == 0]
    walked = plan.tiles_walked * q.shape[0] * plan.block ** 2
    resummed = {n: int(t.item()) for n, t in tally.items()}
    row = {"phase": "v1_kernel_check", "case": name, "dtype": str(q.dtype),
           **{key: b[0] if len(b) == 1 else b for key, b in zip(
               ("body", "dq_body", "dkv_body"), bodies.values())},
           "resummed_cells": resummed, "walked_cells": walked,
           "resummed_share": {n: c / walked for n, c in resummed.items()},
           "shape": list(q.shape), "block": plan.block,
           "walked_tiles": plan.tiles_walked, "arity": arity,
           "arities": _v1_arities(), "empty_block_rows": len(empty),
           "rows_with_no_key": int((refs["lse"] <= bs.VALID_THRESH).sum()),
           "tol": tol, "lse_atol": LSE_ATOL}
    if plain_ms:
        row["plain_ms"] = plain_ms
    row.update(extra or {})
    ok = row["arities"] == {n: {arity: 1} for n in V1_NAMES}
    ok &= bodies == {n: [kernel_body(n, dtype)] for n in V1_NAMES}
    for key, out in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ratio, rel_rms, err, good = compare(out, refs[key], **tol)
        row[f"{key}_max_abs_err"] = err
        row[f"{key}_worst_ratio"] = ratio
        row[f"{key}_rel_rms"] = rel_rms
        ok &= good
    row["lse_max_abs_err"] = float((lse - refs["lse"]).abs().max())
    ok &= row["lse_max_abs_err"] <= LSE_ATOL
    for i in empty:
        h, r = divmod(i, plan.nq)
        cells = slice(r * plan.block, (r + 1) * plan.block)
        ok &= bool((lse[:, h, cells] == bs.NEG_INF).all()) and \
            bool((refs["lse"][:, h, cells] == bs.NEG_INF).all())
    controls = []
    if am is not None:
        controls.append(("the attention mask left out", args, key_mask,
                         None, contextlib.nullcontext()))
    elif key_mask is not None:
        controls.append(("the key mask left out", args, None, None,
                         contextlib.nullcontext()))
    else:
        controls.append(("fp32 inputs: no rounding of p and ds",
                         [t.float() for t in args], None, None,
                         contextlib.nullcontext()))
    if far_row:
        controls.append(("the threshold at -1e29", args, key_mask, am,
                         _attrs(bs, VALID_THRESH=-1e29)))
    if rounding_control:
        fp32 = [t.float() for t in args]
        o_r, _ = bs.bs_fwd_plain(*fp32[:3], key_mask, am, plan, scale)
        ratio, rel_rms, _, good = compare(o_r.to(q.dtype), refs["o"], **tol)
        row["rounding_control"] = {
            "control": "the plain forward on fp32 inputs: p not rounded "
                       "to bf16", "o_worst_ratio": ratio,
            "o_rel_rms": rel_rms, "o_fails": not good}
        ok &= not good
        bwd_r = (*fp32, *bwd[4:])
        got = {"dq": bs.bs_dq_plain(*bwd_r), "dk": bs.bs_dkv_plain(*bwd_r)[0]}
        control = {"control": "the plain backward on fp32 inputs: neither "
                              "ds nor K16's p rounded to bf16"}
        for key, out in got.items():
            ratio, rel_rms, _, good = compare(out.to(q.dtype), refs[key],
                                              **tol)
            control.update({f"{key}_worst_ratio": ratio,
                            f"{key}_rel_rms": rel_rms,
                            f"{key}_fails": not good})
            ok &= not good
        row["backward_rounding_control"] = control
    row["controls"] = {}
    for label, c_args, c_key, c_am, ctx in controls:
        with ctx:
            got = v1_plain_outputs(*c_args, c_key, c_am, plan, scale)
        fails = {}
        for key in ("o", "dq", "dk", "dv"):
            ratio, _, _, good = compare(got[key].to(q.dtype), refs[key],
                                        **tol)
            fails[key] = {"worst_ratio": ratio, "fails": not good}
            ok &= not good
        row["controls"][label] = fails
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"K14-K16 disagree with their plain versions "
                             f"on {name}, or a control passes the check: "
                             f"{row}")
    return row


def v1_far_mask(rng, layout, S, block):
    """An 'add' (S, S) mask of finite N(0, 1) values whose row
    V1_FAR_ROW keeps only three of head 0's walked keys, each at
    V1_FAR_VALUE, and drops the others (-1e30)."""
    import torch
    am = rng.randn(S, S).astype(np.float32)
    keys = np.nonzero(np.kron(layout[0, V1_FAR_ROW // block],
                              np.ones(block)))[0][:3]
    am[V1_FAR_ROW] = -1e30
    am[V1_FAR_ROW, keys] = V1_FAR_VALUE
    return torch.from_numpy(am).cuda()


def v1_kernel_check_phase():
    """Phase 32: K14, K15 and K16 against their plain versions on the
    card: (a) the row-run main shape (B 8, H 16, S 2048, D 64, bf16, the
    fixed layouts of ds_config_sparse.json at block 16, the sparse
    route's key mask, a 'mul' mask keeping 90%), (b) the same without
    the attention mask (BERT's arity), (c) the s8k geometry without
    masks, BSLongformer (window 3) and BigBird at block 128, each plain
    call timed once; then (d) at S 512: 'add' masks of finite values with
    a row whose only keys sit at -5e28, a hand-made layout with an empty
    block row and column, blocks 32, 64 and 128, fp32, a batch row of
    pads. Returns the rows of (a), (b) and (c) by case."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
        NEG_INF, TriplePlan, _to_additive)
    rng = np.random.RandomState(SEED + 30)
    m = V2_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    bf16 = torch.bfloat16
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    plan = TriplePlan(sparse_config("fixed", heads=H).make_layout(S), 16)
    main = train_inputs(rng, B, H, H, S, D, bf16)
    kpm = bert_key_mask(rng, B, S, SPARSE_MIN_LEN, pad=NEG_INF)
    am = _to_additive(v2_mask(rng, S), "mul")
    rows = {"a": check_v1_kernels("bert_large_s2048_fixed_am_kpm", plan,
                                  main, kpm, am, flush=flush,
                                  rounding_control=True),
            "b": check_v1_kernels("bert_large_s2048_fixed_kpm", plan, main,
                                  kpm, None, flush=flush,
                                  rounding_control=True)}
    del main, kpm, am
    s8 = S8K_SHAPE
    args = train_inputs(rng, s8["B"], s8["H"], s8["H"], s8["S"], s8["D"],
                        bf16)
    for kind in ("lf", "bb"):
        rows[kind] = check_v1_kernels(
            f"s8k_{kind}_plain", TriplePlan(s8k_config(kind, s8["H"])
                                            .make_layout(s8["S"]),
                                            s8["block"]),
            args, None, None, flush=flush)
    del args, flush
    b, h, s = 2, 4, 512
    hand = (np.random.RandomState(SEED + 31).rand(h, 16, 16) < 0.4
            ).astype(np.int32)
    hand[0, 3] = 0                        # an empty block row
    hand[1, :, 5] = 0                     # an empty block column
    hand[0, V1_FAR_ROW // 32, :2] = 1     # walked keys for the far row
    cases = [
        # name, layout, block, dtype, key mask pad, far mask
        ("far_row_hand_block32_fp32", hand, 32, torch.float32, -1e9, True),
        ("far_row_hand_block32_bf16", hand, 32, bf16, NEG_INF, True),
        ("bigbird_block64_bf16", BigBirdSparsityConfig(
            num_heads=h, block=64).make_layout(s), 64, bf16, NEG_INF, False),
        ("fixed_block128_fp32", sparse_config("fixed", heads=h)
         .make_layout(s)[:, ::8, ::8], 128, torch.float32, NEG_INF, True),
    ]
    for name, lay, blk, dtype, pad, far in cases:
        args = train_inputs(rng, b, h, h, s, 64, dtype)
        key = bert_key_mask(rng, b, s, 200, all_pad_rows=(1,), pad=pad)
        am = (v1_far_mask(rng, lay, s, blk) if far
              else _to_additive(v2_mask(rng, s, "add"), "add"))
        row = check_v1_kernels(name, TriplePlan(lay, blk), args, key, am,
                               far_row=far)
        if pad == NEG_INF and row["rows_with_no_key"] < h * s:
            raise AssertionError(f"{name}: the pad row must be keyless: "
                                 f"{row}")
    return rows


def v1_kernel_timing_phase(smi, check_rows):
    """Phase 33: K14, K15 and K16 timed as train_kernel_timing times
    them (L2 flushed) at (a) and (b) of phase 32 (the row-run main shape
    with and without the attention mask) and (c) (the s8k geometry,
    BSLongformer and BigBird, no masks), each beside its bound (the bytes
    moved once, the mask's once per distinct (qb, kb) tile of the heads'
    union, or the layout's FLOP at the dense bf16 peak), the plain
    version's one call (phase 32), SDPA with the dense float (B, H, S, S)
    mask (the library column: forward for K14, backward for K15 and K16
    together) and K8-K10 on the same inputs (with the mask tiles at (a),
    their no-mask arity at (b) and (c)). Returns the timings by case."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
    from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
        NEG_INF, _to_additive)
    rng = np.random.RandomState(SEED + 32)
    bytes_per_s, flops_per_s = card_peaks(smi)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    m, s8 = V2_SHAPE, S8K_SHAPE
    main = train_inputs(rng, m["B"], m["H"], m["H"], m["S"], m["D"],
                        torch.bfloat16)
    kpm = bert_key_mask(rng, m["B"], m["S"], SPARSE_MIN_LEN, pad=NEG_INF)
    am = _to_additive(v2_mask(rng, m["S"]), "mul")
    fixed = sparse_config("fixed", heads=m["H"]).make_layout(m["S"])
    s8k_args = train_inputs(rng, s8["B"], s8["H"], s8["H"], s8["S"],
                            s8["D"], torch.bfloat16)
    cases = {  # case: (layout, block, inputs, key mask, attention mask)
        "a": (fixed, 16, main, kpm, am), "b": (fixed, 16, main, kpm, None),
        "lf": (s8k_config("lf", s8["H"]).make_layout(s8["S"]), 128,
               s8k_args, None, None),
        "bb": (s8k_config("bb", s8["H"]).make_layout(s8["S"]), 128,
               s8k_args, None, None)}
    out = {}
    for case, (layout, blk, args, key, amask) in cases.items():
        q, k, v, do = args
        B, H, S, D = q.shape
        scale = 1.0 / float(np.sqrt(D))
        plan = bs.TriplePlan(layout, blk)
        bs.reset_launches()
        o, lse = bs.bs_fwd(q, k, v, key, amask, plan, scale)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, key, amask, plan, scale)
        rp = v2.RowRunPlan(layout, blk, None, per_coord=amask is not None)
        tiles = None if amask is None else rp.mask_tiles(amask)
        o2, lse2 = v2.blocksparse_v2_fwd(q, k, v, key, tiles, rp, scale)
        bwd2 = (q, k, v, do, lse2, (do.float() * o2.float()).sum(-1), key,
                tiles, rp, scale)
        dense = dense_layout_mask(layout, blk)[None]
        if key is not None:
            dense = dense + key[:, None, None, :]
        if amask is not None:
            dense = dense + amask[None, None]
        dense = dense.to(torch.bfloat16)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=dense)
        lib = {"fwd": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=dense), SPARSE_TIMED_CALLS, flush),
            "bwd": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do, retain_graph=True),
                SPARSE_TIMED_CALLS, flush)}
        del sdpa_out, qs, ks, vs, dense
        tile = B * H * S * D * q.element_size()
        rowvec = B * H * S * 4
        union = int((layout.sum(0) > 0).sum())
        masks = (0 if key is None else key.numel() * 4) + \
            (0 if amask is None else union * blk * blk * 4)
        walks = {w: sum(a.nbytes for a in getattr(plan, w))
                 for w in ("rows", "cols")}
        tiles_fine = int(layout.astype(bool).sum())
        specs = {  # name: (call, K8-K10 call, dots, bytes in, bytes out)
            "bs_fwd": (lambda: bs.bs_fwd(q, k, v, key, amask, plan, scale),
                       lambda: v2.blocksparse_v2_fwd(q, k, v, key, tiles,
                                                     rp, scale),
                       2, 3 * tile + masks + walks["rows"], tile + rowvec),
            "bs_dq": (lambda: bs.bs_dq(*bwd),
                      lambda: v2.blocksparse_v2_dq(*bwd2), 3,
                      4 * tile + 2 * rowvec + masks + walks["rows"], tile),
            "bs_dkv": (lambda: bs.bs_dkv(*bwd),
                       lambda: v2.blocksparse_v2_dkv(*bwd2), 4,
                       4 * tile + 2 * rowvec + masks + walks["cols"],
                       2 * tile)}
        out[case] = {}
        for name, (call, row_run, dots, b_in, b_out) in specs.items():
            t = {"ms": time_ms(call, SPARSE_TIMED_CALLS, flush),
                 "plain_ms": check_rows[case]["plain_ms"][name],
                 "library_ms": lib["fwd" if name == "bs_fwd" else "bwd"],
                 "row_run_ms": time_ms(row_run, SPARSE_TIMED_CALLS, flush),
                 "replaces": V1_REPLACES[name],
                 "fma_body_ms": FMA_BODY_MS.get(
                     ("v1_kernel_timing", name, case)),
                 **_bounds(tiles_fine * B * dots * 2 * blk * blk * D,
                           b_in, b_out, bytes_per_s, flops_per_s)}
            emit({"phase": "v1_kernel_timing", "kernel": name, "case": case,
                  "arity": bs.v1_arity(key, amask), "block": blk,
                  "body": kernel_body(name),
                  "shape": [B, H, S, D], "dtype": "bf16",
                  "walked_tiles": plan.tiles_walked, "union_tiles": union,
                  "kernel_ms": t["ms"], **t,
                  "body": kernel_body(name),
                  "library": "scaled_dot_product_attention "
                             + ("forward" if name == "bs_fwd" else
                                "backward (dq, dk, dv together)")
                             + ", dense float (B, H, S, S) mask",
                  "row_run": "K8-K10 " + ("with the mask tiles"
                                          if amask is not None
                                          else "without a mask tile")
                             + f", walk {rp.block}",
                  "achieved_tflop_per_s": t["flops"] / t["ms"] / 1e9,
                  "nvidia_smi": smi})
            out[case][name] = t
        _check_mma_bodies("v1_kernel_timing", _mma_bodies(V1_NAMES))
        del o, lse, delta, bwd, o2, lse2, bwd2, tiles
    return out


def v1_entry_point_phase(smi, legacy_ms, dense_s8k):
    """Phase 34: SparseSelfAttention under USE_SPLASH_V2 = False with the
    config's sparse_attention section, the 'mul' key mask and an (S, S)
    'mul' mask at the row-run main shape, forward and backward (1
    warm-up, V2_ITERS timed): ms, peak memory, one launch of each of
    K14-K16 per call in the "am kpm" arity and no other attention kernel.
    Then a 2-head fp32 call, the v1 kernel path against its plain path
    (TRAIN_TOL fp32) and against the default route's K8-K10 (JAX's
    v2-vs-v1 tolerance). Then bench.py's v1 fallback at the s8k geometry
    (USE_MASKED_FLASH, USE_SPLASH_V2 and USE_BANDED False) for
    BSLongformer and BigBird, beside phase 26's legacy calls
    (``legacy_ms``) and phase 29's dense side (``dense_s8k``). Returns
    the launches by path."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseSelfAttention, sparsity_config_from_dict)
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        planned_kernel
    from deepspeed_tpu_torch.runtime.config import get_sparse_attention
    rng = np.random.RandomState(SEED + 33)
    m = V2_SHAPE
    B, H, S, D = m["B"], m["H"], m["S"], m["D"]
    with open(SPARSE_DS_CONFIG) as f:
        sa = get_sparse_attention(json.load(f))
    lengths = rng.randint(SPARSE_MIN_LEN, S + 1, size=B)
    keep = torch.from_numpy((np.arange(S)[None, :] < lengths[:, None]
                             ).astype(np.float32)).cuda()
    am = v2_mask(rng, S)

    def timed_calls(module, qkv, g, **kw):
        def call():
            o = module(*qkv, **kw)
            (o.float() * g.float()).sum().backward()
            return o
        call()
        torch.cuda.synchronize()
        for t in qkv:
            t.grad = None
        torch.cuda.reset_peak_memory_stats()
        _reset_all_launches()
        t0 = time.perf_counter()
        for _ in range(V2_ITERS):
            o = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = bool(torch.isfinite(o).all()) and all(
            bool(torch.isfinite(t.grad).all()) for t in qkv)
        for t in qkv:
            t.grad = None
        return {"ms_per_fwd_bwd": wall / V2_ITERS * 1e3,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "finite": finite}

    def check_launches(row, arity):
        got, arities = _all_launches(), _v1_arities()
        row.update(launches={n: got[n] for n in V1_NAMES},
                   arities=arities,
                   launches_by_body=_mma_bodies(V1_NAMES),
                   other_attention_launches={
                       n: c for n, c in got.items() if n not in V1_NAMES})
        emit(row)
        if arities != {n: {arity: V2_ITERS} for n in V1_NAMES} or \
                any(row["other_attention_launches"].values()) or \
                not row["finite"]:
            raise AssertionError(f"want {V2_ITERS} launches of each of "
                                 f"K14-K16 in {arity!r} and no other: {row}")
        _check_mma_bodies(row["phase"], row["launches_by_body"])
        return row["launches"]

    launches = {}
    q, k, v, g = train_inputs(rng, B, H, H, S, D, torch.bfloat16)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    ssa = SparseSelfAttention(sparsity_config_from_dict(sa, num_heads=H),
                              key_padding_mask_mode="mul")
    with _v1_flags():
        route = planned_kernel(ssa.get_layout(S), 16, has_am=True)
        row = {"phase": "v1_entry_point", "path": "attn_mask",
               "entry": "SparseSelfAttention(sparsity_config_from_dict("
                        "ds_config_sparse.json), key_padding_mask_mode="
                        "'mul')(q, k, v, key_padding_mask, attn_mask)",
               "route": route, "shape": dict(m, dtype="bf16"),
               "attn_mask": f"'mul', keeps {V2_KEEP}", "iters": V2_ITERS,
               "warmup": 1, **timed_calls(ssa, qkv, g,
                                          key_padding_mask=keep,
                                          attn_mask=am),
               "nvidia_smi": smi}
    launches["attn_mask"] = check_launches(row, "am kpm")
    del q, k, v, g, qkv

    # 2 heads, fp32: the v1 kernel path against its plain path and
    # against the default route's K8-K10
    ssa2 = SparseSelfAttention(sparsity_config_from_dict(sa, num_heads=2),
                               key_padding_mask_mode="mul")
    q, k, v, g = train_inputs(rng, B, 2, 2, S, D, torch.float32)
    results = {}
    for path in ("v1 kernel", "v1 plain", "v2 kernel"):
        qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = sum(_v1_launches().values())
        with (_v1_flags() if path.startswith("v1") else
              contextlib.nullcontext()), \
                (_plain_triples() if path == "v1 plain"
                 else contextlib.nullcontext()):
            o = ssa2(*qkv, key_padding_mask=keep, attn_mask=am)
            (o.float() * g.float()).sum().backward()
        ran = sum(_v1_launches().values()) > before
        if ran != (path == "v1 kernel"):
            raise AssertionError(f"the {path} path ran K14-K16: {ran}")
        results[path] = [o.detach()] + [t.grad for t in qkv]
    tol = TRAIN_TOL["fp32"]
    row = {"phase": "v1_entry_point_kernel_vs_plain", "heads": 2,
           "dtype": "fp32", "tol": tol,
           "v2_tol": {"o": [1e-5, 1e-5], "grads": [5e-5, 5e-4]}, "ok": True}
    for key, a, p, r in zip(("o", "dq", "dk", "dv"), results["v1 kernel"],
                            results["v1 plain"], results["v2 kernel"]):
        ratio, _, err, good = compare(a, p, **tol)
        atol, rtol = (1e-5, 1e-5) if key == "o" else (5e-5, 5e-4)
        v2_ratio, _, v2_err, v2_good = compare(r, a, atol, rtol, None)
        row.update({f"{key}_vs_plain_worst_ratio": ratio,
                    f"{key}_vs_plain_max_abs_err": err,
                    f"{key}_vs_v2_worst_ratio": v2_ratio,
                    f"{key}_vs_v2_max_abs_err": v2_err})
        row["ok"] &= good and v2_good
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"SparseSelfAttention on v1: the kernel path "
                             f"differs from the plain path or K8-K10: {row}")
    del q, k, v, g, results

    # bench.py's v1 fallback of the s8k row
    s8 = S8K_SHAPE
    q, k, v, g = train_inputs(rng, s8["B"], s8["H"], s8["H"], s8["S"],
                              s8["D"], torch.bfloat16)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    for kind in ("lf", "bb"):
        ssa = SparseSelfAttention(s8k_config(kind, s8["H"]))
        with _v1_flags(USE_MASKED_FLASH=False, USE_BANDED=False):
            route = planned_kernel(ssa.get_layout(s8["S"]), s8["block"])
            row = {"phase": "v1_entry_point", "path": f"s8k {kind} fallback",
                   "flags": "USE_MASKED_FLASH, USE_SPLASH_V2, USE_BANDED = "
                            "False (bench.py:614-629)",
                   "route": route, "shape": dict(s8, dtype="bf16"),
                   "iters": V2_ITERS, "warmup": 1,
                   **timed_calls(ssa, qkv, g), "nvidia_smi": smi}
        row["legacy_dispatch_ms_phase26"] = legacy_ms[kind]
        row["dense_flash_ms_phase29"] = dense_s8k["ms_per_fwd_bwd"]
        launches[f"s8k {kind}"] = check_launches(row, "plain")
    return launches


V1_ROUTE = Route(dict.fromkeys(V1_NAMES, 1), _plain_triples, "_v1",
                 "K14-K16 (v1, key-mask arity)",
                 ("bs_fwd_", "bs_dq_", "bs_dkv_"), planned="v1")


def bert_sparse_training_v1_phase(smi, fixed_losses, randn_ms):
    """Phase 35: phase 19's fixed configuration under USE_MASKED_FLASH =
    False and USE_SPLASH_V2 = False (K14-K16 in the key-mask arity, 48
    launches of each per step and no other attention kernel), 1 warm-up
    and 3 timed steps and a 1-step profile (K14-K16's ms per launch there
    beside ``randn_ms``, phase 33's (b) times by kernel), its losses
    beside phase 19's (same seed and batches); then phase 20's
    kernel-vs-plain check of it (2 layers, fp32, at seq 2048). Returns the
    launches."""
    with _v1_flags(USE_MASKED_FLASH=False):
        got, losses = bert_training_phase(
            smi, seq=SPARSE_SEQ, min_len=SPARSE_MIN_LEN, steps=SPARSE_STEPS,
            warmup=SPARSE_WARMUP, sparse="fixed", route=V1_ROUTE,
            randn_ms=dict(zip(V1_ROUTE.profiled,
                              (randn_ms[n]["ms"] for n in V1_NAMES))))
        emit({"phase": "bert_sparse_training_v1_losses", "seed": SEED,
              "v1_route": losses, "fixed_k1_k3_phase19": fixed_losses,
              "max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                  zip(losses, fixed_losses))})
        bert_kernel_vs_plain_phase(batch=2, seq=SPARSE_SEQ, sparse="fixed",
                                   route=V1_ROUTE)
    return got


# --------------------------------------------------------------- Llama
LLAMA_DS_CONFIG = "examples/llama/ds_config_zero2.json"
LLAMA_SEQ = 1024
LLAMA_GQA_TRAIN_SHAPE = dict(B=8, H=32, Hkv=8, S=LLAMA_SEQ, D=64, block=128)
# device groups of the Llama step's profile beside K1-K3 and the GEMMs:
# the optimizer's torch._foreach_* passes (Adam, the clipping's scale)
LLAMA_PROFILE_GROUPS = {"optimizer": ("multi_tensor_apply",)}


def _check_bodies(phase, bodies, dtype):
    """Every launch of K1-K3 in ``bodies`` ran ``dtype``'s body."""
    want = kernel_body("masked_flash_fwd", dtype)
    if any(set(b) - {want} for b in bodies.values()):
        raise AssertionError(f"{phase}: a {dtype} launch of K1-K3 ran "
                             f"another body than {want!r}: {bodies}")


def llama_train_kernel_vs_plain_phase(device="cuda", batch=2, seq=LLAMA_SEQ,
                                      config=None):
    """The LLAMA_1B widths at 2 layers in fp32: llama_loss_fn's loss and
    every grad through K1-K3 at G 4 against their plain versions, then
    with remat=True against the non-remat kernel path, each at
    TRAIN_MODEL_LOSS_RTOL and TRAIN_MODEL_GRAD_TOL; K1-K3's launches per
    loss and backward in both modes, every one on the fp32 body. Returns
    {mode: launches}."""
    import torch
    from deepspeed_tpu_torch.models.llama import (init_llama_params,
                                                  llama_loss_fn)
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg = (config or llama_1b_config())._replace(num_layers=2)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    params = init_llama_params(cfg, gen)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    ids = np.random.RandomState(SEED + 4).randint(
        0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    data = {"input_ids": torch.from_numpy(ids).to(device)}
    results = {}
    for path, remat in (("kernel", False), ("plain", False),
                        ("kernel_remat", True)):
        _reset_all_launches()
        with (MASKED_ROUTE.plain() if path == "plain"
              else contextlib.nullcontext()):
            loss = llama_loss_fn(cfg, dtype=torch.float32, remat=remat)(
                params, data, None)
            grads = torch.autograd.grad(loss, leaves)
        launches, other = MASKED_ROUTE.launches()
        bodies = _mma_bodies(KPM_NAMES)
        if any(other.values()):
            raise AssertionError(f"other attention kernels launched: "
                                 f"{other}")
        _check_bodies(f"llama_train_kernel_vs_plain {path}", bodies, "fp32")
        results[path] = (float(loss.detach()), grads, launches)

    def differ(a, b):
        (la, ga, _), (lb, gb, _) = results[a], results[b]
        worst = max(float((x - y).abs().max())
                    / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(ga, gb))
        return abs(la - lb) / abs(lb), worst
    want = {"kernel": dict.fromkeys(KPM_NAMES, cfg.num_layers),
            "plain": dict.fromkeys(KPM_NAMES, 0),
            "kernel_remat": {"masked_flash_fwd": 2 * cfg.num_layers,
                             "masked_flash_dq": cfg.num_layers,
                             "masked_flash_dkv": cfg.num_layers}}
    row = {"phase": "llama_train_kernel_vs_plain", "model": "llama-1b-width",
           "layers": cfg.num_layers, "dtype": "fp32", "batch": batch,
           "seq": seq, "group": cfg.num_heads // cfg.kv_heads,
           "loss_rtol": TRAIN_MODEL_LOSS_RTOL,
           "grad_tol": TRAIN_MODEL_GRAD_TOL, "grads": len(leaves),
           "launches": {p: r[2] for p, r in results.items()},
           "launches_want": want}
    ok = all(results[p][2] == want[p] for p in want)
    for name, (a, b) in (("kernel_vs_plain", ("kernel", "plain")),
                         ("remat_vs_kernel", ("kernel_remat", "kernel"))):
        loss_rel, worst = differ(a, b)
        row[name] = {"loss_a": results[a][0], "loss_b": results[b][0],
                     "loss_rel_err": loss_rel, "worst_grad_rel_err": worst}
        ok &= loss_rel <= TRAIN_MODEL_LOSS_RTOL and \
            worst <= TRAIN_MODEL_GRAD_TOL
    row["ok"] = ok
    emit(row)
    if not ok:
        raise AssertionError(f"llama kernel path differs from the plain "
                             f"path or from its remat, or launched other "
                             f"counts: {row}")
    return {p: r[2] for p, r in results.items()}


def _obs_report():
    """tools/obs_report.py (stdlib only), loaded from the checkout."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "obs_report.py")
    spec = importlib.util.spec_from_file_location("obs_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def llama_training_phase(smi, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
                         remat_steps=2, device="cuda", config=None,
                         seq=LLAMA_SEQ, batch=None):
    """LLAMA_1B (16 layers, nothing cut) trained through initialize +
    train_batch with examples/llama/ds_config_zero2.json as held (micro
    batch 8, bf16 over fp32 masters, Adam betas 0.9/0.95 and weight decay
    0.1, WarmupLR, clipping 1.0, ZeRO 2 on one device) at seq 1024, with
    observability.enabled into a temporary events_dir; synthetic ids as
    the example makes them (a fresh batch each step from RandomState(0)).
    ``warmup`` then ``steps`` timed steps: step ms, tokens/s, peak memory,
    K1-K3's launches per step (all on the tensor-core body), MFU by
    PERF.md's formula and by the Observer's counted FLOPs; a profile of 2
    more steps (idle share, time by group) and the fp32 head alone; then
    ``remat_steps`` steps under remat=True (launches per step, step ms).
    The events log must give tools/obs_report.py's summary a step count,
    step time, MFU, FLOPs per step and peak memory. Returns the timed
    steps' launches. ``device``, ``config``, ``seq`` and ``batch`` (the
    micro batch) let a CPU run rehearse it at a tiny size (no profile,
    no head timing, no peak memory there)."""
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (count_params,
                                                  init_llama_params,
                                                  llama_loss_fn)
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()
    cfg = config or llama_1b_config()
    with open(LLAMA_DS_CONFIG) as f:
        ds_config = json.load(f)
    if batch is not None:
        ds_config["train_micro_batch_size_per_gpu"] = batch
    events_dir = tempfile.mkdtemp(prefix="llama_obs_")
    ds_config["observability"] = {"enabled": True, "events_dir": events_dir}
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_llama_params(cfg, gen)
    n_params = count_params(params)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(cfg), model_parameters=params, config=ds_config,
        device=device)
    del params
    batch = engine.train_micro_batch_size_per_gpu()
    rng = np.random.RandomState(SEED)

    def micro_batches():
        while True:
            yield {"input_ids": rng.randint(
                0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)}
    it = micro_batches()
    for _ in range(warmup):
        engine.train_batch(it)
    sync()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(it))
    sync()
    wall = time.perf_counter() - t0
    launches, other = MASKED_ROUTE.launches()
    bodies = _mma_bodies(KPM_NAMES)
    losses = [float(x) for x in losses]
    L, H = cfg.num_layers, cfg.hidden_size
    step_s = wall / steps
    tokens_per_s = batch * seq / step_s
    _, peak_flops = card_peaks(smi)
    flops_per_token = 6 * n_params + 12 * L * seq * H
    prof = engine.observability.flops_profiles["micro_step"]
    mfu_formula = flops_per_token * tokens_per_s / peak_flops
    mfu_counted = prof.flops / step_s / peak_flops
    row = {"phase": "llama_training", "model": "llama-1b",
           "params": n_params, "config": LLAMA_DS_CONFIG, "batch": batch,
           "seq": seq, "group": cfg.num_heads // cfg.kv_heads,
           "dtype": "bf16 over fp32 masters", "warmup_steps": warmup,
           "steps": steps, "step_ms": step_s * 1e3,
           "tokens_per_s": tokens_per_s, "losses": losses,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                 if on_cuda else None),
           "kernel_launches": launches,
           "kernel_launches_per_step": {n: c / steps
                                        for n, c in launches.items()},
           "other_attention_launches": other, "launches_by_body": bodies,
           "flops_per_token_formula": flops_per_token,
           "flops_per_step_formula": flops_per_token * batch * seq,
           "flops_per_step_counted": prof.flops,
           "counted_kernel_flops": prof.kernel_flops,
           "counted_over_formula": prof.flops / (flops_per_token * batch
                                                 * seq),
           "mfu_formula": mfu_formula, "mfu_counted": mfu_counted,
           "mfu_counted_over_formula": mfu_counted / mfu_formula,
           "nvidia_smi": smi}
    emit(row)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite llama training loss: {losses}")
    for name, n in launches.items():
        if n != L * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"llama steps, want {L} per step")
    if any(other.values()):
        raise AssertionError(f"other attention kernels launched: {other}")
    _check_mma_bodies("llama_training", bodies)
    if prof.uncounted or not prof.flops > 0:
        raise AssertionError(f"the Observer counted no FLOPs: {prof}")
    profile, head = {}, {}
    if on_cuda:
        profile = train_profile_phase(engine, next(it), row["step_ms"],
                                      phase="llama_train_profile",
                                      extra_groups=LLAMA_PROFILE_GROUPS)
        head = head_phase(engine, cfg, batch, seq, row["step_ms"],
                          head="lm_head", phase="llama_train_head")
    engine.close()
    summary = _obs_report().summarize(events_dir)
    shutil.rmtree(events_dir, ignore_errors=True)
    # the trained weights again under remat: K1 twice per layer
    del ds_config["observability"]
    trained = engine.module_params
    del engine
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=llama_loss_fn(cfg, remat=True), model_parameters=trained,
        config=ds_config, device=device)
    del trained
    engine.train_batch(it)
    sync()
    _reset_all_launches()
    t0 = time.perf_counter()
    for _ in range(remat_steps):
        engine.train_batch(it)
    sync()
    remat_ms = (time.perf_counter() - t0) / remat_steps * 1e3
    remat_launches, other = MASKED_ROUTE.launches()
    remat_bodies = _mma_bodies(KPM_NAMES)
    del engine
    obs = {"steps": summary["steps"],
           "step_time_ms_p50": summary["step_time_ms"]["p50"],
           "samples_per_sec_last": summary["samples_per_sec"]["last"],
           "mfu_best": summary["mfu"]["best"],
           "flops_per_step": summary["flops_per_step"],
           "bytes_accessed": summary["bytes_accessed"],
           "peak_bytes_in_use": summary["memory"]["peak_bytes_in_use"],
           "loss_first": summary["loss"]["first"],
           "loss_last": summary["loss"]["last"]}
    want_remat = {"masked_flash_fwd": 2 * L, "masked_flash_dq": L,
                  "masked_flash_dkv": L}
    emit({"phase": "llama_training_remat", "steps": remat_steps,
          "step_ms": remat_ms, "over_no_remat": remat_ms / row["step_ms"],
          "kernel_launches_per_step": {n: c / remat_steps
                                       for n, c in remat_launches.items()},
          "launches_by_body": remat_bodies, "nvidia_smi": smi})
    emit({"phase": "llama_training_obs_report", **obs,
          "device_idle_share": profile.get("device_idle_share"),
          "head_fwd_bwd_ms": head.get("fwd_bwd_ms")})
    if any(remat_launches[n] != want_remat[n] * remat_steps
           for n in want_remat) or any(other.values()):
        raise AssertionError(f"remat launches {remat_launches} (other "
                             f"{other}), want {want_remat} per step")
    _check_mma_bodies("llama_training_remat", remat_bodies)
    if not (obs["steps"] >= 1 and (obs["step_time_ms_p50"] or 0) > 0
            and (obs["mfu_best"] or 0) > 0
            and (obs["flops_per_step"] or 0) > 0
            and (obs["peak_bytes_in_use"] or 0) > 0):
        raise AssertionError(f"obs_report's summary of the run lacks a "
                             f"number: {obs}")
    return launches


def llama_gqa_kernel_timing_phase(smi):
    """K1, K2 and K3 alone at the Llama step's shape (B 8, 32 q heads over
    8 kv heads, S 1024, D 64, bf16, causal, block 128): held against
    their plain versions (TRAIN_TOL, with the rounding control; one timed
    plain call each), then timed as phase 6 times them beside the bound
    (the causal cells' FLOP or the bytes moved once), SDPA with
    enable_gqa=True (forward; backward for dq, dk and dv together) and,
    on its own line, K3's group sum of the fp32 per-q-head partials.
    Returns {kernel: row} for the kernels line."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import masked_flash as mf
    from deepspeed_tpu_torch.ops.attention.masked_flash import BlockMask
    m = LLAMA_GQA_TRAIN_SHAPE
    B, H, Hkv, S, D = m["B"], m["H"], m["Hkv"], m["S"], m["D"]
    rng = np.random.RandomState(SEED + 5)
    q, k, v, do = train_inputs(rng, B, H, Hkv, S, D, torch.bfloat16)
    mask = BlockMask.causal(S, m["block"])
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    check = check_train_kernels("llama_1b_gqa_g4_causal_bf16", mask,
                                (q, k, v, do), 0.0, control=True,
                                phase="llama_gqa_kernel_check", flush=flush)
    scale = 1.0 / float(np.sqrt(D))
    o, lse = mf.masked_flash_fwd(q, k, v, mask, scale)
    delta = (do.float() * o.float()).sum(-1)
    bytes_per_s, flops_per_s = card_peaks(smi)
    qtile, kvtile, rowvec = B * H * S * D * 2, B * Hkv * S * D * 2, \
        B * H * S * 4
    walks = {"csr": sum(a.nbytes for a in mask.csr()),
             "csc": sum(a.nbytes for a in mask.csc())}
    qs = q.detach().clone().requires_grad_()
    ks = k.detach().clone().requires_grad_()
    vs = v.detach().clone().requires_grad_()

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              enable_gqa=True)
    sdpa_out = sdpa(qs, ks, vs)
    sdpa_fwd_ms = time_ms(lambda: sdpa(q, k, v), TIMED_CALLS, flush)
    sdpa_bwd_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                    retain_graph=True), TIMED_CALLS, flush)
    specs = {
        # name: (call, dots per cell, bytes in, bytes out, walk, library)
        "masked_flash_fwd": (
            lambda: mf.masked_flash_fwd(q, k, v, mask, scale), mf.FWD_DOTS,
            qtile + 2 * kvtile, qtile + rowvec, "csr", sdpa_fwd_ms),
        "masked_flash_dq": (
            lambda: mf.masked_flash_dq(q, k, v, do, lse, delta, mask, scale),
            mf.DQ_DOTS, 2 * qtile + 2 * kvtile + 2 * rowvec, qtile, "csr",
            sdpa_bwd_ms),
        "masked_flash_dkv": (
            lambda: mf.masked_flash_dkv(q, k, v, do, lse, delta, mask,
                                        scale),
            mf.DKV_DOTS, 2 * qtile + 2 * kvtile + 2 * rowvec, 2 * kvtile,
            "csc", sdpa_bwd_ms)}
    errs = {"masked_flash_fwd": check["o_max_abs_err"],
            "masked_flash_dq": check["dq_max_abs_err"],
            "masked_flash_dkv": max(check["dk_max_abs_err"],
                                    check["dv_max_abs_err"])}
    out = {}
    for name, (call, dots, b_in, b_out, walk, lib) in specs.items():
        kernel_ms = time_ms(call, TIMED_CALLS, flush)
        flops = causal_cells(S, S) * H * B * dots * 2 * D
        nbytes = b_in + b_out + walks[walk]
        bytes_ms = nbytes / bytes_per_s * 1e3
        ops_ms = flops / flops_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        row = {"phase": "llama_gqa_kernel_timing", "kernel": name,
               "shape": dict(m, dtype="bf16", mask="causal"),
               "flops": flops, "bytes": nbytes, "kernel_ms": kernel_ms,
               "plain_ms": check["plain_ms"][name], "library_ms": lib,
               "library": ("scaled_dot_product_attention forward, "
                           "enable_gqa" if name == "masked_flash_fwd" else
                           "scaled_dot_product_attention backward, "
                           "enable_gqa (dq, dk, dv together)"),
               "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "body": kernel_body(name), "max_abs_err": errs[name],
               "achieved_tflop_per_s": flops / kernel_ms / 1e9,
               "nvidia_smi": smi}
        if name == "masked_flash_dkv":
            # the fp32 per-q-head partials K3 writes at G > 1, summed per
            # group outside the kernel: read 2 x (B, H, S, D) fp32, write
            # dk, dv in bf16
            part = torch.randn((B, H, S, D), device="cuda")
            part_v = torch.randn((B, H, S, D), device="cuda")
            sum_ms = time_ms(lambda: mf._group_sum(part, part_v, k, v),
                             TIMED_CALLS, flush)
            sum_bytes = 2 * B * H * S * D * 4 + 2 * kvtile
            row["group_sum"] = {
                "ms": sum_ms, "share_of_kernel": sum_ms / kernel_ms,
                "bytes": sum_bytes,
                "bound_ms": sum_bytes / bytes_per_s * 1e3,
                "partials_bytes": 2 * B * H * S * D * 4}
        emit(row)
        out[name] = {k_: row[k_] for k_ in ("plain_ms", "library_ms",
                                            "bound_ms", "bound_by",
                                            "max_abs_err")}
        out[name]["ms"] = kernel_ms
        if "group_sum" in row:
            out[name]["group_sum_ms"] = row["group_sum"]["ms"]
    return out


CKPT_DS_CONFIG = "examples/megatron_gpt2/ds_config_zero2.json"
CKPT_HALF = 3             # steps before the save, and after the resume
CKPT_TRACE = dict(start_step=2, num_steps=2)
CKPT_SERVE_PROMPT, CKPT_SERVE_NEW, CKPT_SERVE_REQUESTS = 128, 32, 4
# two tags of ~12 bytes per parameter (fp32 masters and two moments),
# and the headroom of a staging dir's small files
CKPT_SPACE_FACTOR = 2 * 12 * 1.05


def fs_of(path):
    """(mount point, file system type) that holds ``path``, from
    /proc/mounts (read only)."""
    import os
    path = os.path.realpath(path)
    best = ("", "unknown")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, mnt, typ = line.split()[:3]
                inside = path == mnt or path.startswith(
                    mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best[0]):
                    best = (mnt, typ)
    except OSError:
        pass
    return best


def _host_copy(tree):
    """A CPU copy of a tensor tree (a snapshot the engine's in-place
    updates do not move)."""
    from deepspeed_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _engine_state(engine):
    """The params and both moments of a training engine, as one list."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    st = engine.opt_state
    return [t for tree in (engine.params, st.exp_avg, st.exp_avg_sq)
            for t in tree_leaves(tree)]


def _tag_bytes(tag_dir):
    import os
    return sum(os.path.getsize(os.path.join(tag_dir, f))
               for f in os.listdir(tag_dir))


def _scalars(events_dir, tag):
    import os
    rows = []
    with open(os.path.join(events_dir, "events.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if row.get("tag") == tag:
                rows.append(row["value"])
    return rows


def _trace_contents(path, kernels):
    """The ``train_batch#<step>`` labels of a Chrome trace and the count
    of device kernels whose name holds each of ``kernels``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted({int(e["name"].split("#")[1]) for e in events
                    if str(e.get("name", "")).startswith("train_batch#")})
    counts = {k: sum(1 for e in events if e.get("cat") == "kernel"
                     and k in str(e.get("name", ""))) for k in kernels}
    return steps, counts


def checkpoint_resume_phase(smi, root, device="cuda", config=None,
                            seq=1024, batch=None, half=CKPT_HALF):
    """GPT-2 345M (all 24 layers, dropout 0.1 as the config has it) with
    examples/megatron_gpt2/ds_config_zero2.json as held (micro batch 8,
    bf16 over fp32 masters, Adam, WarmupLR, clipping 1.0, ZeRO 2 on one
    device) at seq 1024, observed, on 2 * ``half`` batches of synthetic
    ids from seed 0:

    - run A takes them straight, under the trace window at steps 2-3
      (the trace must hold K1-K3's kernels of those 2 steps only and
      their ``train_batch#`` labels), and run A2 again without it: their
      spread;
    - run B takes ``half`` steps and saves; a new engine, made from
      other weights and another seed, loads the directory: every param
      and moment equals B's at the save bitwise; it takes ``half`` more
      steps, whose losses must equal A's (bitwise, or within A's spread
      against A2), and saves again;
    - every K1-K3 launch of B's runs is counted (on the tensor-core
      body), both tags pass the port's verify CLI, obs_report reads 2
      saves, 1 load and 1 resume.

    Prints the tag's bytes, the snapshot, write, CRC-verify and load
    times beside the step time, with the file system. Everything is
    written under ``root``, which the caller deletes. Returns the state
    the serving and fallback phases read."""
    import os
    import shutil
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_MEDIUM, count_params,
                                                 gpt2_loss_fn,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt
    cfg = config or GPT2_MEDIUM
    on_cuda = torch.device(device).type == "cuda"
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CKPT_DS_CONFIG)) as f:
        ds = json.load(f)
    if batch is not None:
        ds["train_micro_batch_size_per_gpu"] = batch
    batch = ds["train_micro_batch_size_per_gpu"]
    save_dir = os.path.join(root, "ckpt")
    mount, fstype = fs_of(root)
    free = shutil.disk_usage(root).free
    rng = np.random.RandomState(SEED)
    data = [{"input_ids": rng.randint(0, cfg.vocab_size, (batch, seq + 1))
             .astype(np.int32)} for _ in range(2 * half)]

    def engine(seed, name, trace=None):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_gpt2_params(cfg, gen)
        events = os.path.join(root, f"events_{name}")
        obs = {"enabled": True, "events_dir": events}
        if trace is not None:
            obs["trace"] = trace
        conf = dict(ds, observability=obs)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(cfg), model_parameters=params, config=conf,
            device=device, seed=seed)
        return eng, events

    def steps(eng, batches):
        out = [eng.train_batch(iter([b])) for b in batches]
        return [float(x) for x in out]

    state = {"root": root, "save_dir": save_dir, "config": cfg,
             "train_engine": engine}
    # -- A: straight, under the trace window; A2: straight again --
    eng_a, _ = engine(SEED, "a", trace=dict(
        CKPT_TRACE, enabled=True, output_path=os.path.join(root, "trace")))
    n_params = count_params(eng_a.params)
    need = int(n_params * CKPT_SPACE_FACTOR)
    emit({"phase": "checkpoint_disk", "dir": root, "mount": mount,
          "fs_type": fstype, "free_bytes": free, "need_bytes": need})
    if free < need:
        raise AssertionError(
            f"checkpoint_resume: {root} ({fstype} at {mount}) has "
            f"{free} bytes free, the two tags need about {need}")
    losses_a = steps(eng_a, data)
    eng_a.close()
    trace_steps, trace_kernels = _trace_contents(
        eng_a.trace_path, ("mf_fwd_mma_kernel", "mf_dq_mma_kernel",
                           "mf_dkv_mma_kernel"))
    trace = {"path": os.path.basename(eng_a.trace_path),
             "bytes": os.path.getsize(eng_a.trace_path),
             "steps": trace_steps, "kernels": trace_kernels}
    del eng_a
    eng_a2, _ = engine(SEED, "a2")
    losses_a2 = steps(eng_a2, data[:1])
    if on_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses_a2 += steps(eng_a2, data[1:])      # float() syncs each step
    step_ms = (time.perf_counter() - t0) * 1e3 / (len(data) - 1)
    eng_a2.close()
    del eng_a2
    spread = [abs(x - y) for x, y in zip(losses_a, losses_a2)]

    # -- B: half the steps, save; a new engine loads and runs the rest --
    if on_cuda:
        torch.cuda.synchronize()
    _reset_all_launches()
    eng_b, events_b = engine(SEED, "b")
    losses_b = steps(eng_b, data[:half])
    t0 = time.perf_counter()
    tag3 = eng_b.save_checkpoint(save_dir)
    save_ms = (time.perf_counter() - t0) * 1e3
    at_save = [t.detach().clone() for t in _engine_state(eng_b)]
    state["params3"] = _host_copy(eng_b.params)
    t0 = time.perf_counter()
    ok, problems = ckpt.verify_checkpoint_dir(tag3)
    verify_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        raise AssertionError(f"checkpoint_resume: {tag3}: {problems}")
    eng_b.close()
    del eng_b
    eng_c, _ = engine(SEED + 1, "b")      # other weights, another seed
    if all(torch.equal(x, y) for x, y in zip(_engine_state(eng_c),
                                              at_save)):
        raise AssertionError("checkpoint_resume: the new engine starts "
                             "with B's state: the load proves nothing")
    t0 = time.perf_counter()
    path, _ = eng_c.load_checkpoint(save_dir)
    if on_cuda:
        torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    loaded = _engine_state(eng_c)
    unequal = sum(not torch.equal(x, y) for x, y in zip(loaded, at_save))
    del at_save, loaded
    if path != tag3 or eng_c.global_steps != half or unequal:
        raise AssertionError(
            f"checkpoint_resume: loaded {path} at step "
            f"{eng_c.global_steps}; {unequal} params or moments differ "
            "from B's at the save")
    losses_c = steps(eng_c, data[half:])
    tag6 = eng_c.save_checkpoint(save_dir)
    state["params6"] = _host_copy(eng_c.params)
    eng_c.close()
    del eng_c
    launches, other = MASKED_ROUTE.launches()
    bodies = _mma_bodies(KPM_NAMES)

    # -- the verify CLI on both tags, obs_report on the events --
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.tools.verify_checkpoint",
         save_dir, "--all", "--expect-step", str(2 * half)],
        capture_output=True, text=True, cwd=here, timeout=600)
    cli_s = time.perf_counter() - t0
    summary = _obs_report().summarize(events_b)
    snapshot_ms = _scalars(events_b, "Checkpoint/snapshot_ms")
    write_ms = _scalars(events_b, "Checkpoint/write_ms")
    tag_bytes = _tag_bytes(tag3)
    resumed = losses_a[half:]
    worst = max(spread[half:])
    row = {"phase": "checkpoint_resume", "model": "gpt2-345m",
           "params": n_params, "batch": batch, "seq": seq,
           "ds_config": CKPT_DS_CONFIG, "dropout": cfg.attn_dropout,
           "losses_a": losses_a, "losses_a2": losses_a2,
           "straight_spread": spread, "losses_b": losses_b,
           "losses_resumed": losses_c,
           "resumed_bitwise": losses_c == resumed,
           "resumed_max_abs_diff": max(abs(x - y) for x, y in
                                       zip(losses_c, resumed)),
           "tags": [os.path.basename(tag3), os.path.basename(tag6)],
           "tag_bytes": tag_bytes, "step_ms": step_ms,
           "save_ms": save_ms, "snapshot_ms": snapshot_ms,
           "write_ms": write_ms,
           "write_gb_per_s": tag_bytes / (write_ms[0] / 1e3) / 1e9,
           "crc_verify_ms": verify_ms,
           "crc_verify_gb_per_s": tag_bytes / (verify_ms / 1e3) / 1e9,
           "load_ms": load_ms, "verify_cli_s": cli_s,
           "verify_cli_rc": cli.returncode,
           "fs_type": fstype, "mount": mount,
           "trace": trace,
           "obs_report": summary["checkpoints"],
           "resumes": summary["elastic"]["resumes"],
           "kernel_launches": launches, "other_attention_launches": other,
           "launches_by_body": bodies, "nvidia_smi": smi}
    emit(row)
    if not all(np.isfinite(losses_a + losses_c)):
        raise AssertionError(f"checkpoint_resume: non-finite losses {row}")
    if losses_b != losses_a[:half] and \
            max(abs(x - y) for x, y in zip(losses_b, losses_a)) > \
            max(spread[:half]):
        raise AssertionError("checkpoint_resume: run B's first steps left "
                             f"run A's spread: {losses_b} vs {losses_a}")
    if any(abs(x - y) > worst for x, y in zip(losses_c, resumed)):
        raise AssertionError(
            f"checkpoint_resume: the resumed losses {losses_c} differ from "
            f"the straight run's {resumed} beyond its own spread {worst}")
    if trace_steps != list(range(CKPT_TRACE["start_step"],
                                 CKPT_TRACE["start_step"]
                                 + CKPT_TRACE["num_steps"])):
        raise AssertionError(f"checkpoint_resume: the trace holds steps "
                             f"{trace_steps}, want 2 and 3")
    want = cfg.num_layers * CKPT_TRACE["num_steps"]
    if on_cuda and any(n != want for n in trace_kernels.values()):
        raise AssertionError(f"checkpoint_resume: the trace holds K1-K3 "
                             f"kernels {trace_kernels}, want {want} each")
    for name, n in launches.items():
        if n != cfg.num_layers * 2 * half:
            raise AssertionError(f"checkpoint_resume: {name} launched {n} "
                                 f"times in run B's {2 * half} steps")
    if any(other.values()):
        raise AssertionError(f"checkpoint_resume: other attention kernels "
                             f"launched: {other}")
    if on_cuda:
        _check_mma_bodies("checkpoint_resume", bodies)
    if cli.returncode != 0:
        raise AssertionError(f"checkpoint_resume: the verify CLI exited "
                             f"{cli.returncode}:\n{cli.stdout[-2000:]}"
                             f"\n{cli.stderr[-2000:]}")
    ck = summary["checkpoints"]
    if (ck["saves"], ck["loads"], summary["elastic"]["resumes"]) != \
            (2, 1, 1):
        raise AssertionError(f"checkpoint_resume: obs_report read {ck} and "
                             f"{summary['elastic']['resumes']} resumes, "
                             "want 2 saves, 1 load, 1 resume")
    state.update(launches=launches, tag3=tag3, tag6=tag6)
    return state


def _first_decode_logits(engine):
    """Record the logits of the engine's first decode dispatch from here
    on (``rec["logits"]``, fp32 on the host), by wrapping its sampler."""
    rec = {"in_decode": False}
    dispatch, sample = engine._dispatch, engine._sample_tokens

    def sample_rec(logits, *args):
        if rec["in_decode"] and "logits" not in rec:
            rec["logits"] = logits.detach().float().cpu()
        return sample(logits, *args)

    def dispatch_rec(name, *args):
        rec["in_decode"] = name == "decode"
        try:
            return dispatch(name, *args)
        finally:
            rec["in_decode"] = False
    engine._sample_tokens = sample_rec
    engine._dispatch = dispatch_rec
    return rec


def _serve_checked(engine, prompts, new_tokens):
    """Warm up, then serve ``prompts`` greedily: (tokens per request, the
    first decode step's logits, K4's launches, decode dispatches, the
    program set's rows)."""
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.ops.attention.paged import \
        paged_decode_attention
    engine.warmup()
    rec = _first_decode_logits(engine)
    decode0 = engine.dispatches["decode"]
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_int8 = 0
    uids = [engine.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                  temperature=0.0, seed=i))
            for i, p in enumerate(prompts)]
    done = {f.uid: f for f in engine.run()}
    out = [done[u].tokens for u in uids]
    if any(len(t) != new_tokens for t in out):
        raise AssertionError(f"serve_from_checkpoint: lengths "
                             f"{[len(t) for t in out]}")
    return (out, rec["logits"], paged_decode_attention.launches,
            paged_decode_attention.launches_int8,
            engine.dispatches["decode"] - decode0,
            check_graphs("serve_from_checkpoint", engine))


def serve_from_checkpoint_phase(smi, state, device="cuda",
                                prompt_len=CKPT_SERVE_PROMPT,
                                new_tokens=CKPT_SERVE_NEW,
                                requests=CKPT_SERVE_REQUESTS):
    """InferenceEngine.from_checkpoint(d, GPT2_MEDIUM, tag="global_step3")
    over the bf16 paged pool serves ``requests`` greedy requests of
    ``prompt_len`` tokens: its tokens, and its first decode step's logits
    bitwise, equal those of an engine built from run B's in-memory params
    at step 3; then swap_params(d, "global_step6") between requests: the
    same against an engine of the step-6 params, at weight_version
    global_step6, ordinal 1. K4 runs once per layer per decode step.
    Returns K4's launches on this path by tag served (each count set to
    0 just before its requests)."""
    import torch
    from deepspeed_tpu_torch import InferenceEngine
    cfg, save_dir = state["config"], state["save_dir"]
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, cfg.vocab_size, size=prompt_len).tolist()
               for _ in range(requests)]

    def reference(params):
        eng = InferenceEngine(cfg, params, {}, dtype=torch.bfloat16,
                              device=device)
        got = _serve_checked(eng, prompts, new_tokens)
        del eng
        return got

    ref3, ref6 = reference(state["params3"]), reference(state["params6"])
    t0 = time.perf_counter()
    engine = InferenceEngine.from_checkpoint(
        save_dir, cfg, tag="global_step3", dtype=torch.bfloat16,
        device=device)
    load_ms = (time.perf_counter() - t0) * 1e3
    got3 = _serve_checked(engine, prompts, new_tokens)
    version3 = engine.debug_state()["weight_version"]
    t0 = time.perf_counter()
    engine.swap_params(save_dir, tag="global_step6")
    swap_ms = (time.perf_counter() - t0) * 1e3
    st = engine.debug_state()
    got6 = _serve_checked(engine, prompts, new_tokens)
    layers = cfg.num_layers
    rows = {"global_step3": (got3, ref3), "global_step6": (got6, ref6)}
    row = {"phase": "serve_from_checkpoint", "model": "gpt2-345m",
           "kv_dtype": "bfloat16", "requests": requests,
           "prompt_len": prompt_len, "new_tokens": new_tokens,
           "from_checkpoint_ms": load_ms, "swap_ms": swap_ms,
           "versions": [version3, st["weight_version"]],
           "weight_ordinal": st["weight_ordinal"],
           "tokens_equal": {t: g[0] == r[0] for t, (g, r) in rows.items()},
           "logits_bitwise": {t: bool(torch.equal(g[1], r[1]))
                              for t, (g, r) in rows.items()},
           "logits_max_abs_diff": {
               t: float((g[1] - r[1]).abs().max()) for t, (g, r) in
               rows.items()},
           "kernel_launches": {t: g[2] for t, (g, _) in rows.items()},
           "int8_launches": {t: g[3] for t, (g, _) in rows.items()},
           "decode_dispatches": {t: g[4] for t, (g, _) in rows.items()},
           "programs": {t: g[5]["programs"] for t, (g, _) in rows.items()},
           "steady_state_recompiles": {
               t: g[5]["steady_state_recompiles"]
               for t, (g, _) in rows.items()},
           "nvidia_smi": smi}
    emit(row)
    if (version3, st["weight_version"], st["weight_ordinal"]) != \
            ("global_step3", "global_step6", 1):
        raise AssertionError(f"serve_from_checkpoint: versions {row}")
    for tag, (g, r) in rows.items():
        if g[0] != r[0] or not torch.equal(g[1], r[1]):
            raise AssertionError(f"serve_from_checkpoint: {tag}'s tokens "
                                 "or first decode logits differ from the "
                                 "in-memory params' engine")
        if g[3] or g[2] != g[4] * layers or g[2] <= 0:
            raise AssertionError(
                f"serve_from_checkpoint: {tag}: K4 launched {g[2]} times "
                f"(int8 {g[3]}) for {g[4]} decode steps x {layers} layers")
    state["engine"], state["prompts"] = engine, prompts
    state["tokens6"], state["new_tokens"] = got6[0], new_tokens
    return {t: g[2] for t, (g, _) in rows.items()}


def checkpoint_fallback_phase(smi, state):
    """After serving used it, a bit flipped in global_step6's model shard:
    verify_checkpoint_dir names the CRC32 mismatch; the serving engine's
    swap to it raises and it keeps serving global_step6's weights (the
    same tokens); a new training engine's load_checkpoint(tag=None) falls
    back to global_step3 (its params equal B's at step 3 bitwise) and
    writes a fallback row that obs_report counts."""
    import os
    import torch
    from deepspeed_tpu_torch.runtime import checkpoint as ckpt
    from deepspeed_tpu_torch.runtime import fault
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    save_dir, engine = state["save_dir"], state.pop("engine")
    victim = os.path.join(state["tag6"], "model_states.shard_0.npz")
    offset = fault.flip_byte(victim)
    ok, problems = ckpt.verify_checkpoint_dir(state["tag6"])
    if ok or not any("CRC32" in p for p in problems):
        raise AssertionError(f"checkpoint_fallback: the flipped tag "
                             f"verified: {problems}")
    try:
        engine.swap_params(save_dir, tag="global_step6")
        swapped = True
    except FileNotFoundError:
        swapped = False
    out = _serve_checked(engine, state["prompts"], state["new_tokens"])[0]
    still = (engine.weight_version, engine.weight_ordinal)
    del engine
    eng, events = state["train_engine"](SEED + 2, "fallback")
    path, _ = eng.load_checkpoint(save_dir)
    equal = all(torch.equal(x.cpu(), y) for x, y in zip(
        tree_leaves(eng.params), tree_leaves(state["params3"])))
    step = eng.global_steps
    eng.close()
    del eng
    summary = _obs_report().summarize(events)["checkpoints"]
    row = {"phase": "checkpoint_fallback", "flipped": os.path.basename(
        victim), "offset": offset, "problems": problems,
           "corrupt_swap_raised": not swapped, "serving_after": still,
           "tokens_unchanged": out == state["tokens6"],
           "loaded": os.path.basename(path or ""), "step": step,
           "params_equal_step3": equal, "obs_report": summary,
           "nvidia_smi": smi}
    emit(row)
    if swapped or still != ("global_step6", 1) or \
            out != state["tokens6"]:
        raise AssertionError(f"checkpoint_fallback: the swap to the "
                             f"corrupt tag did not roll back: {row}")
    if path != state["tag3"] or step != CKPT_HALF or not equal:
        raise AssertionError(f"checkpoint_fallback: loaded {path} at step "
                             f"{step}, params equal {equal}")
    if (summary["fallbacks"], summary["loads"]) != (1, 1):
        raise AssertionError(f"checkpoint_fallback: obs_report read "
                             f"{summary}, want 1 fallback and 1 load")


# ------------------------------------------------------------------ #
# phases 53-54: ZeRO-Offload and the launcher (ZeRO 2 over NCCL)
# ------------------------------------------------------------------ #
OFFLOAD_DS_CONFIG = "examples/megatron_gpt2/ds_config_offload.json"
ZERO2_DS_CONFIG = "examples/megatron_gpt2/ds_config_zero2.json"
# phase 53: the offload masters after 3 steps against the device Adam's.
# JAX's own tolerance for this comparison, in fp32
# (tests/unit/test_cpu_adam.py::test_engine_offload_matches_device_adam),
# is rtol 1e-4, atol 1e-5. In bf16 the host's fp64 clip norm against the
# device's fp32 one leaves a master a rounding apart, so a bf16 param can
# sit one ulp apart and its next grads differ; where such a grad is near
# zero the two Adams may step an entry in opposite directions, each by at
# most about lr. So every entry is held within atol 2 x the lrs of the
# steps taken (7.1e-5 with WarmupLR's first three), and the share of
# entries outside the fp32 tolerance under OFFLOAD_SHARE_LIMIT.
# WarmupLR's lr at step 0 is 0, so only steps 1 and 2 move a master, each
# by about lr: a host Adam that updates nothing, or steps the wrong way,
# still sits inside that atol. What fails them: the share (a no-op puts
# most entries outside the fp32 tolerance), each leaf's update (masters
# minus the initial params) against the device Adam's, as
# ||host - device|| / ||device update|| (a no-op reads 1, a sign flip 2)
# under OFFLOAD_UPDATE_LIMIT["leaf"], and over all leaves under
# OFFLOAD_UPDATE_LIMIT["all"], and the step-2 loss
# within OFFLOAD_LOSS_ATOL of the device Adam's (a no-op's is the initial
# params' loss on that batch, which the overlapped run (b) measures). A
# leaf's limit is wide because the key third of the fused qkv bias has an
# exact grad of 0: its grads are rounding, which Adam scales to steps of
# about lr in whatever direction the rounding took.
OFFLOAD_TOL = dict(rtol=1e-4, atol=1e-5)
OFFLOAD_SHARE_LIMIT = 1e-3
OFFLOAD_UPDATE_LIMIT = {"leaf": 0.5, "all": 0.05}
OFFLOAD_LOSS_ATOL = 2e-4
OFFLOAD_BATCHES = 4
LAUNCH_STEPS = 3


def _ds_config(rel):
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, rel)) as f:
        return json.load(f)


def _offload_data(cfg, batch, n, seq=1024):
    rng = np.random.RandomState(SEED)
    return [{"input_ids": rng.randint(0, cfg.vocab_size, (batch, seq + 1))
             .astype(np.int32)} for _ in range(n)]


def _bf16_engine(cfg, params, ds, device):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, dtype=torch.bfloat16, deterministic=True),
        model_parameters=params, config=ds, device=device, seed=SEED)
    return engine


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return list(tree_leaves(tree))


def zero_offload_train_phase(smi, device="cuda", config=None, seq=1024):
    """Phase 53: GPT-2 345M (the example's 50304-token vocab, dropout 0,
    all 24 layers) through examples/megatron_gpt2/ds_config_offload.json
    (ZeRO 2, cpu_offload, micro batch 4, ga 1, bf16, Adam with weight
    decay, WarmupLR, clipping 1.0) at seq 1024 on 4 batches from seed 0.

    (a) the config with overlap_comm false against the stage-0 device
    Adam of the same optimizer, schedule and clipping: the losses of steps
    0-1 bitwise (WarmupLR's lr at step 0 is 0, so step 1 reads the
    initial params on both sides), step 2's within OFFLOAD_LOSS_ATOL; the
    host masters after 3 steps against the device masters as the note at
    OFFLOAD_TOL says (every entry, the share beyond the fp32 tolerance,
    each leaf's update), each check beside what a host Adam that updates
    nothing, or steps the wrong way, would read; the fourth step through
    forward / backward / step, split into device fwd/bwd, grad D2H, host
    prep, the C++ Adam and the param H2D. (b) the config as held
    (overlap_comm): after window 1 the device params are bitwise the
    initial ones, after window 2 bitwise (a)'s after its step 1 (the
    initial ones again, lr 0), after window 3 bitwise (a)'s after its
    step 2, which differ from (a)'s after steps 1 and 3: one window
    behind, no more and no less; synchronize() applies every update (the
    device params bitwise the masters' bf16). The masters must live on
    the host and the device hold no Adam moment. Returns the launches of
    K1-K3 in (a) and (b)."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import (count_params,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.utils.tree import tree_map_with_path
    cfg = config or gpt2_345m_train_config()
    on_cuda = torch.device(device).type == "cuda"
    ds = _ds_config(OFFLOAD_DS_CONFIG)
    batch = ds["train_micro_batch_size_per_gpu"]
    data = _offload_data(cfg, batch, OFFLOAD_BATCHES, seq)
    params = init_gpt2_params(cfg, torch.Generator(device=device)
                              .manual_seed(SEED))
    n_params = count_params(params)
    init = [t.detach().float().cpu().reshape(-1) for t in _leaves(params)]
    names = _leaves(tree_map_with_path(lambda path, _: "/".join(path),
                                       params))

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    def peak_reset():
        if on_cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def allocated():
        return torch.cuda.memory_allocated() if on_cuda else 0

    def host_params(engine):
        return [t.detach().to("cpu", copy=True) for t in _leaves(
            engine.params)]

    def same(x, y):
        return all(torch.equal(u.cpu(), v) for u, v in zip(x, y))

    def timed_steps(engine, batches):
        losses, times = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(iter([b]))))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    # -- the stage-0 device Adam, the reference of (a); peak memory from
    # -- the first step on --
    dev = _bf16_engine(cfg, params, dict(ds, zero_optimization={
        "stage": 0}), device)
    peak_reset()
    dev_losses, dev_ms = timed_steps(dev, data[:3])
    dev_masters = [t.detach().float().cpu() for t in _leaves(dev.params)]
    dev_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    del dev
    _reset_all_launches()

    # -- (a) offload, overlap_comm false --
    before = allocated()
    a = _bf16_engine(cfg, params, dict(ds, zero_optimization=dict(
        ds["zero_optimization"], overlap_comm=False)), device)
    held = allocated() - before
    peak_reset()
    opt = a.optimizer
    if not (a.zero_cpu_offload and a.master is None and a.opt_state == ()
            and all(isinstance(m, np.ndarray) for m in opt.master_params)
            and all(t.dtype == torch.bfloat16 and t.device.type ==
                    torch.device(device).type for t in _leaves(a.params))):
        raise AssertionError("zero_offload: the masters must live on the "
                             "host and the device hold bf16 params only")
    if on_cuda and held > 1.1 * 2 * n_params:
        raise AssertionError(f"zero_offload: the engine holds {held} bytes "
                             f"on the device for {n_params} bf16 params: "
                             "masters or moments on the card")
    a_losses, a_ms = timed_steps(a, data[:1])
    a1 = host_params(a)
    more, more_ms = timed_steps(a, data[1:2])
    a2 = host_params(a)
    more3, more3_ms = timed_steps(a, data[2:3])
    a_losses += more + more3
    a_ms += more_ms + more3_ms
    a2_moved = not same(a1, a2) and not same(_leaves(a.params), a2)
    masters3 = [torch.from_numpy(m.copy()) for m in opt.master_params]
    tol = dict(OFFLOAD_TOL, atol=2 * sum(a._lr_at(i) for i in range(3)))
    # the masters against the device Adam's, and what a host Adam that
    # updates nothing (masters = init) or steps the wrong way (init minus
    # the device's update) would read
    worst, within = 0.0, True
    beyond = {"offload": 0, "no_update": 0, "sign_flip": 0}
    update_err, update_err_sq, update_sq = {}, 0.0, 0.0
    for name, m, d, p0 in zip(names, masters3, dev_masters, init):
        d = d.reshape(-1)
        upd = d - p0
        worst = max(worst, float((m - d).abs().max()))
        within &= bool(torch.allclose(m, d, **tol))
        for key, v in (("offload", m), ("no_update", p0),
                       ("sign_flip", p0 - upd)):
            beyond[key] += int((~torch.isclose(v, d, **OFFLOAD_TOL)).sum())
        e, u = float(torch.linalg.vector_norm(m - d)), \
            float(torch.linalg.vector_norm(upd))
        update_err[name] = e / u if u else (0.0 if e == 0 else math.inf)
        update_err_sq += e * e
        update_sq += u * u
    share = {k: v / n_params for k, v in beyond.items()}
    update_err_all = math.sqrt(update_err_sq / update_sq)
    worst_leaves = sorted(update_err.items(), key=lambda kv: -kv[1])[:3]
    del masters3, init
    # the fourth step in three calls, each part timed on the host clock
    sync()
    t0 = time.perf_counter()
    a.forward(data[3])
    a.backward()
    sync()
    t1 = time.perf_counter()
    a.step()
    sync()
    t2 = time.perf_counter()
    st = dict(a.offload_stats)
    split = {"device_fwd_bwd_ms": (t1 - t0) * 1e3, "grad_d2h_ms":
             st["d2h_ms"], "host_prep_ms": st["prep_ms"],
             "host_adam_ms": st["adam_ms"],
             "param_h2d_ms": (t2 - t1) * 1e3 - st["d2h_ms"] - st["prep_ms"]
             - st["adam_ms"], "step_ms": (t2 - t0) * 1e3}
    offload_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    adam_bytes = 30 * n_params     # p, g, m, v read; p, m, v written; bf16
    simd, threads = opt.simd_width(), opt.omp_threads()
    lrs = [a._lr_at(i) for i in range(OFFLOAD_BATCHES)]
    del a, opt

    # -- (b) as held: overlap_comm, one window behind --
    b = _bf16_engine(cfg, params, ds, device)
    b_init = host_params(b)
    del params
    # the params after windows 1-3, cloned on the device (a copy to the
    # host between windows would give the worker thread's Adam time that
    # the overlapped step must not get), compared after the run
    b_losses, b_ms, after = [], [], []
    for k in range(3):
        more, more_ms = timed_steps(b, data[k:k + 1])
        b_losses += more
        b_ms += more_ms
        after.append([t.detach().clone() for t in _leaves(b.params)])
    more, more_ms = timed_steps(b, data[3:])
    b_losses += more
    b_ms += more_ms
    pending = b._offload_pending is not None
    windows = [same(x, want) for x, want in zip(after, (b_init, a1, a2))]
    del after, b_init, a1, a2
    b.synchronize()
    if not (pending and b._offload_pending is None and
            b.optimizer.step_count == b.global_steps == OFFLOAD_BATCHES):
        raise AssertionError("zero_offload overlap: synchronize() did not "
                             "apply every update")
    for t, m in zip(_leaves(b.params), b.optimizer.master_params):
        if not torch.equal(t.reshape(-1).cpu(), torch.from_numpy(m).to(
                torch.bfloat16)):
            raise AssertionError("zero_offload overlap: the device params "
                                 "are not the masters' after synchronize")
    b.close()
    del b
    launches = _train_launches()
    L = cfg.num_layers
    want = L * 2 * OFFLOAD_BATCHES
    # b_losses[2] is the initial params' loss on batch 2 (window 3 reads
    # them): the step-2 loss of a host Adam that updates nothing
    loss2 = abs(a_losses[2] - dev_losses[2])
    loss2_no_update = abs(b_losses[2] - dev_losses[2])
    emit({"phase": "zero_offload_train", "model": "gpt2-345m",
          "params": n_params, "config": OFFLOAD_DS_CONFIG, "batch": batch,
          "seq": seq, "lrs": lrs, "losses_offload": a_losses,
          "losses_device_adam": dev_losses, "losses_overlap": b_losses,
          "loss2_abs_diff": loss2, "loss2_abs_diff_no_update":
          loss2_no_update, "loss2_atol": OFFLOAD_LOSS_ATOL,
          "masters_max_abs_diff": worst, "tolerance": tol,
          "masters_share_beyond_fp32_tolerance": share["offload"],
          "share_beyond_if_no_update": share["no_update"],
          "share_beyond_if_sign_flipped": share["sign_flip"],
          "share_limit": OFFLOAD_SHARE_LIMIT,
          "update_rel_err_worst_leaves": worst_leaves,
          "update_rel_err_all": update_err_all,
          "update_rel_err_limit": OFFLOAD_UPDATE_LIMIT,
          "windows_one_behind": windows, "a2_moved": a2_moved,
          "step_ms_offload": a_ms, "step_ms_overlap": b_ms,
          "step_ms_device_adam": dev_ms, "split_step4": split,
          "host_adam_gb_per_s": adam_bytes / (st["adam_ms"] / 1e3) / 1e9,
          "host_adam_bytes": adam_bytes, "simd_width": simd,
          "omp_threads": threads, "engine_device_bytes": held,
          "peak_memory_bytes_offload": offload_peak,
          "peak_memory_bytes_device_adam": dev_peak,
          "peak_memory_saved_bytes": dev_peak - offload_peak,
          "kernel_launches": launches, "nvidia_smi": smi})
    if a_losses[:2] != dev_losses[:2]:
        raise AssertionError(f"zero_offload: the losses of steps 0-1 "
                             f"{a_losses[:2]} != the device Adam's "
                             f"{dev_losses[:2]}")
    if not loss2 <= OFFLOAD_LOSS_ATOL < loss2_no_update:
        raise AssertionError(f"zero_offload: step 2's loss is {loss2} from "
                             f"the device Adam's (atol {OFFLOAD_LOSS_ATOL}; "
                             f"no update would read {loss2_no_update})")
    if not within:
        raise AssertionError(f"zero_offload: host masters after 3 steps "
                             f"differ from the device Adam's beyond {tol} "
                             f"(max |diff| {worst})")
    if not share["offload"] <= OFFLOAD_SHARE_LIMIT < min(
            share["no_update"], share["sign_flip"]):
        raise AssertionError(f"zero_offload: shares of the masters beyond "
                             f"the fp32 tolerance {share} (limit "
                             f"{OFFLOAD_SHARE_LIMIT})")
    if not (worst_leaves[0][1] <= OFFLOAD_UPDATE_LIMIT["leaf"] and
            update_err_all <= OFFLOAD_UPDATE_LIMIT["all"]):
        raise AssertionError(f"zero_offload: the host updates are "
                             f"{update_err_all} of the device Adam's away "
                             f"over all leaves, {worst_leaves} in the "
                             f"worst (limits {OFFLOAD_UPDATE_LIMIT})")
    if not (all(windows) and a2_moved):
        raise AssertionError(f"zero_offload overlap: after windows 1-3 the "
                             f"params equal (init, (a)'s after steps 1 and "
                             f"2): {windows}; (a)'s after step 2 differ from "
                             f"its after steps 1 and 3: {a2_moved}")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"zero_offload: K1-K3 launched {launches}, "
                             f"want {want} each ((a) and (b), 4 steps each)")
    _check_mma_bodies("zero_offload_train", _mma_bodies(
        ("masked_flash_fwd", "masked_flash_dq", "masked_flash_dkv")))
    return launches


def _zero2_losses(cfg, device, steps=LAUNCH_STEPS, seq=1024):
    """GPT-2 345M (dropout 0) through ds_config_zero2.json as held, seed 0,
    ``steps`` batches from seed 0: the losses (floats)."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import init_gpt2_params
    ds = _ds_config(ZERO2_DS_CONFIG)
    data = _offload_data(cfg, ds["train_micro_batch_size_per_gpu"], steps,
                         seq)
    params = init_gpt2_params(cfg, torch.Generator(device=device)
                              .manual_seed(SEED))
    engine = _bf16_engine(cfg, params, ds, device)
    del params
    t0 = time.time()
    losses = [float(engine.train_batch(iter([b]))) for b in data]
    return losses, engine, t0


def _process_start() -> float:
    """This process's start, on the wall clock (from /proc)."""
    import os
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")


def _one_chunk_collectives(engine, device="cuda"):
    """ZeroPartition's reduce-scatter and all-gather over the group on
    every leaf shape of ``engine``. At a world of one JAX's rule
    replicates every leaf, so the engine's own step only all-reduces;
    here each leaf is cut into one chunk (along dim 0, every other 2-D
    leaf along dim 1), so that reduce_scatter_tensor and all_gather run,
    and each must give the identity, bitwise: the grads in fp32, the
    params in bf16, as the engine moves them."""
    import torch
    from deepspeed_tpu_torch.runtime.zero.sharding import ZeroPartition
    shapes = [tuple(t.shape) for t in _leaves(engine.params)]
    part = ZeroPartition(shapes, 1, 0, 2)
    part.dims = [None if not s else 1 if len(s) == 2 and i % 2 else 0
                 for i, s in enumerate(shapes)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    wrong = 0
    for i, s in enumerate(shapes):
        g = torch.randn(s, generator=gen, device=device)
        got = part.reduce_scatter(i, g.clone())
        p = g.to(torch.bfloat16)
        out = part.all_gather(i, p, torch.empty_like(p))
        wrong += not (torch.equal(got, g) and torch.equal(out, p))
    return {"live": part.live, "leaves": len(shapes),
            "cut_along_dim1": part.dims.count(1),
            "replicated": part.dims.count(None), "not_identity": wrong}


def zero2_child(result_path):
    """Phase 54's child, launched by the port's runner (one process per
    device): on its first launch it exits 85 before it builds anything;
    on the second it joins the launcher's group (NCCL), trains
    LAUNCH_STEPS steps of ds_config_zero2.json (at one data rank ZeRO 2
    takes stage 0's step, whose collective over the group is the grads'
    all-reduce), then runs the partition's reduce-scatter and
    all-gather on NCCL (:func:`_one_chunk_collectives`) and writes what
    it saw. Prints no result line."""
    import os
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.distributed import init_distributed, local_rank
    start = _process_start()
    restarts = int(os.environ.get("DSTPU_RESTART_COUNT", "0"))
    if restarts == 0:
        return 85
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed()
    _reset_all_launches()
    losses, engine, t_first = _zero2_losses(gpt2_345m_train_config(), "cuda")
    out = {"restarts": restarts, "backend": dist.get_backend(),
           "world": dist.get_world_size(), "rank": dist.get_rank(),
           "local_rank": local_rank(), "device": torch.cuda.current_device(),
           "dp_world_size": engine.dp_world_size,
           "sharded": engine._sharded, "zero_stage": engine.zero_stage,
           "step_over_group": engine._part is not None and
           engine._part.live,
           "losses": losses, "launches": _train_launches(),
           "spawn_to_first_step_s": t_first - start,
           "one_chunk_collectives": _one_chunk_collectives(engine)}
    with open(result_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def zero_launch_phase(smi):
    """Phase 54: ``python -m deepspeed_tpu_torch.launcher.runner --num_gpus
    1 --supervise --max_restarts 1 --restart_backoff 0 chip_smoke.py
    --child zero2 <file>``: the launcher exits 0 after exactly one
    relaunch; the child ran on NCCL at world 1 (rank 0, local rank 0;
    ZeRO 2 at one data rank takes stage 0's step, its grads all-reduced
    over the group) and its 3 losses are bitwise this process's, which
    trains the same config, batches and seed with no group; the
    partition's reduce-scatter and all-gather on NCCL, each leaf as one
    chunk, gave the identity.
    Returns the child's K1-K3 launches (counted in the child)."""
    import os
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    losses, engine, _ = _zero2_losses(gpt2_345m_train_config(), "cuda")
    if torch.distributed.is_initialized() or engine._part is not None:
        raise AssertionError("zero_launch: the parent made a process group")
    del engine
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        result = os.path.join(d, "child.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
             "--num_gpus", "1", "--master_port", str(_free_port()),
             "--supervise", "--max_restarts", "1", "--restart_backoff",
             "0", os.path.join(here, "chip_smoke.py"), "--child", "zero2",
             result], cwd=here, capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        log = p.stdout + p.stderr
        if p.returncode != 0:
            print(log[-4000:], file=sys.stderr)
            raise AssertionError(f"zero_launch: the launcher exited "
                                 f"{p.returncode}")
        with open(result) as f:
            child = json.load(f)
    relaunches = log.count("relaunch 1/1")
    row = {"phase": "zero_launch", "config": ZERO2_DS_CONFIG,
           "launcher_seconds": seconds, "relaunches": relaunches,
           "child": child, "parent_losses": losses, "nvidia_smi": smi}
    emit(row)
    if relaunches != 1 or child["restarts"] != 1:
        raise AssertionError("zero_launch: want exactly one relaunch")
    if (child["backend"], child["world"], child["rank"],
            child["local_rank"]) != ("nccl", 1, 0, 0):
        raise AssertionError(f"zero_launch: the child's group {child}")
    if not (child["step_over_group"] and child["zero_stage"] == 2 and
            child["dp_world_size"] == 1 and not child["sharded"]):
        raise AssertionError("zero_launch: the child did not take ZeRO 2 "
                             "at one data rank over its group")
    coll = child["one_chunk_collectives"]
    if not (coll["live"] and coll["leaves"] and coll["replicated"] == 0
            and coll["not_identity"] == 0):
        raise AssertionError(f"zero_launch: reduce-scatter and all-gather "
                             f"on NCCL: {coll}")
    if child["losses"] != losses:
        raise AssertionError(f"zero_launch: the child's losses "
                             f"{child['losses']} != the parent's {losses}")
    want = gpt2_345m_train_config().num_layers * LAUNCH_STEPS
    if any(n != want for n in child["launches"].values()):
        raise AssertionError(f"zero_launch: K1-K3 launched "
                             f"{child['launches']} in the child, want {want}")
    return child["launches"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    global _START
    _START = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_MEDIUM, gpt2_forward,
                                                 gpt2_generate,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.ops import _build

    # fp32 matmuls in full fp32 (no TF32), for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    built = _build.build_all()
    ptxas = {n: _build.ptxas_summary(log)
             for n, log in _build.build_logs.items()}
    spills = [dict(f, source=n) for n, fs in ptxas.items() for f in fs
              if f.get("spill_stores") or f.get("spill_loads")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(built), "ptxas": ptxas,
          "tensor_core_kernels": sum("_mma_kernel" in f["function"]
                                     for fs in ptxas.values() for f in fs),
          "spills": spills})
    # the tensor-core bodies (K1-K3 and K5-K7 in bf16) and every
    # paged_decode function (K4 and K4q) may not spill
    if any("_mma_kernel" in f["function"] or "paged_decode" in f["function"]
           for f in spills):
        raise AssertionError(f"ptxas spills registers: {spills}")

    timing = kernel_phase(smi)
    int8_timing = int8_kernel_phase(smi)
    train_check = train_kernel_check_phase()
    train_timing = train_kernel_timing_phase(smi)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_gpt2_params(GPT2_MEDIUM, gen)
    launches, prompts, engine, gpt2_tokens = serving_phase(
        GPT2_MEDIUM, params, "cuda", smi)
    profile_phase(engine, prompts)
    del engine
    model_path_phase(GPT2_MEDIUM, params, "cuda", prompts, gpt2_forward)
    gpt2_int8_launches, _, engine, _ = serving_phase(
        GPT2_MEDIUM, params, "cuda", smi,
        inference_config={"paged_kv": {"kv_dtype": "int8"}}, requests=8)
    profile_phase(engine, prompts)
    del engine
    graph_vs_eager_phase(smi, GPT2_MEDIUM, params, "gpt2-345m")
    gpt2_ref = fp32_reference(GPT2_MEDIUM, params,
                              make_prompts(GPT2_MEDIUM.vocab_size))
    gpt2_spec_launches = spec_decode_serving_phase(
        smi, GPT2_MEDIUM, params, "gpt2-345m", gpt2_tokens, ref=gpt2_ref)
    chunked_prefill_serving_phase(smi, GPT2_MEDIUM, params)
    disagg_launches = disagg_serving_phase(smi, GPT2_MEDIUM, params,
                                           gpt2_ref)
    gpt2_quant_launches = quantized_weights_serving_phase(
        smi, GPT2_MEDIUM, params, "gpt2-345m", gpt2_forward)
    dense_cache_serving_phase(smi, GPT2_MEDIUM, params, gpt2_ref)
    gpt2_generate_launches = generate_phase(smi, GPT2_MEDIUM, params,
                                            "gpt2-345m", gpt2_generate)
    fleet_launches = fleet_serving_phase(smi, GPT2_MEDIUM, params, gpt2_ref)
    fleet_child_launches = fleet_process_phase(smi, GPT2_MEDIUM, params,
                                               gpt2_ref)
    del params, gpt2_ref
    torch.cuda.empty_cache()
    offload_launches = zero_offload_train_phase(smi)
    launcher_child_launches = zero_launch_phase(smi)
    llama_launches = llama_phase(smi)
    train_launches, train_losses = training_phase(smi)
    training_dropout_phase()
    train_kernel_vs_plain_phase()
    llama_train_kernel_vs_plain_phase()
    llama_train_launches = llama_training_phase(smi)
    llama_gqa = llama_gqa_kernel_timing_phase(smi)
    ckpt_root = tempfile.mkdtemp(prefix="ckpt_resume_")
    try:
        ckpt_state = checkpoint_resume_phase(smi, ckpt_root)
        ckpt_train_launches = ckpt_state["launches"]
        ckpt_serve_launches = serve_from_checkpoint_phase(smi, ckpt_state)
        ckpt_quant_launches = quantized_from_checkpoint_phase(smi,
                                                              ckpt_state)
        fleet_swap_launches = fleet_swap_phase(smi, ckpt_state)
        checkpoint_fallback_phase(smi, ckpt_state)
        del ckpt_state
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    bert_check = bert_kernel_check_phase()
    bert_timing = bert_kernel_timing_phase(smi)
    bert_launches, _ = bert_training_phase(smi)
    bert_launches_512, _ = bert_training_phase(
        smi, seq=512, min_len=256, steps=BERT_STEPS_512,
        profile=False)
    bert_kernel_vs_plain_phase()
    sparse_check = sparse_kernel_check_phase()
    sparse_timing, fixed_check = sparse_kernel_timing_phase(smi)
    sparse_runs = {kind: bert_training_phase(
        smi, seq=SPARSE_SEQ, min_len=SPARSE_MIN_LEN, steps=SPARSE_STEPS,
        warmup=SPARSE_WARMUP, sparse=kind) for kind in SPARSE_KINDS}
    sparse_launches = {kind: run[0] for kind, run in sparse_runs.items()}
    # the plain versions' per-tile walk of 16 per-head layouts at seq 2048
    # launches ~1e6 small kernels per call: the fixed config runs at 512
    bert_kernel_vs_plain_phase(batch=2, seq=512, sparse="fixed")
    bert_kernel_vs_plain_phase(batch=2, seq=SPARSE_SEQ,
                               sparse="bslongformer")
    v2_check = v2_kernel_check_phase()
    v2_timing = v2_kernel_timing_phase(smi, v2_check)
    v2_launches, band_launches = sparse_self_attention_phase(smi)
    banded_check, banded_bert_check = banded_kernel_check_phase()
    nomask_check = v2_nomask_kernel_check_phase()
    legacy_timing = legacy_sparse_timing_phase(smi)
    entry_launches, entry_ms = legacy_entry_point_phase(smi)
    with _Legacy():
        legacy_bert_launches, _ = bert_training_phase(
            smi, seq=SPARSE_SEQ, min_len=SPARSE_MIN_LEN, steps=SPARSE_STEPS,
            warmup=SPARSE_WARMUP, sparse="bslongformer", route=BANDED_ROUTE)
        bert_kernel_vs_plain_phase(batch=2, seq=SPARSE_SEQ,
                                   sparse="bslongformer", route=BANDED_ROUTE)
    flash_check = flash_kernel_check_phase()
    flash_timing = flash_kernel_timing_phase(smi, entry_ms)
    with _FlashKnob():
        flash_launches, flash_losses = training_phase(
            smi, route=FLASH_ROUTE, profile=False)
        emit({"phase": "training_legacy_losses", "seed": SEED,
               "legacy_route": flash_losses, "default_route": train_losses,
               "max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                   zip(flash_losses, train_losses))})
        training_dropout_phase(route=FLASH_ROUTE)
        train_kernel_vs_plain_phase(route=FLASH_ROUTE)
        flash_bert_launches, _ = bert_training_phase(
            smi, steps=BERT_LEGACY_STEPS, warmup=BERT_LEGACY_WARMUP,
            profile=False, route=FLASH_ROUTE)
        bert_kernel_vs_plain_phase(route=FLASH_ROUTE)
    v1_check = v1_kernel_check_phase()
    v1_timing = v1_kernel_timing_phase(smi, v1_check)
    v1_launches = v1_entry_point_phase(smi, entry_ms,
                                       flash_timing["s8k_entry_point"])
    v1_launches["bert"] = bert_sparse_training_v1_phase(
        smi, sparse_runs["fixed"][1], v1_timing["b"])

    kernels = [dict(
        name="paged_decode", route="cuda",
        source="deepspeed_tpu_torch/csrc/paged_decode.cu",
        replaces="deepspeed_tpu/ops/attention/paged.py:217",
        launches=(launches + llama_launches["bf16"] + gpt2_spec_launches
                  + llama_launches["spec"]
                  + sum(ckpt_serve_launches.values()) + disagg_launches
                  + gpt2_quant_launches["bf16"]
                  + llama_launches["quant"]["bf16"]
                  + sum(ckpt_quant_launches.values())
                  + fleet_launches + fleet_swap_launches),
        launches_by_path={"gpt2-345m bf16 pool": launches,
                          "llama-1b bf16 pool": llama_launches["bf16"],
                          "gpt2-345m bf16 pool, spec_decode k 4 (plain "
                          "decode dispatches)": gpt2_spec_launches,
                          "llama-1b bf16 pool, spec_decode k 4 (plain "
                          "decode dispatches)": llama_launches["spec"],
                          **{f"gpt2-345m from_checkpoint {tag}, bf16 pool":
                             n for tag, n in ckpt_serve_launches.items()},
                          "gpt2-345m disagg (shared pool, separate pools, "
                          "separate pools + spec; plain decode "
                          "dispatches)": disagg_launches,
                          "gpt2-345m int8-resident weights, bf16 pool":
                              gpt2_quant_launches["bf16"],
                          "llama-1b int8-resident weights, bf16 pool":
                              llama_launches["quant"]["bf16"],
                          **{f"gpt2-345m from_checkpoint global_step3, "
                             f"quantize_weights {mode}, bf16 pool": n
                             for mode, n in ckpt_quant_launches.items()},
                          "gpt2-345m fleet, 2 in-process fp32 replicas, "
                          "drain with live migration (phase 50)":
                              fleet_launches,
                          "gpt2-345m fleet swap_weights to global_step6, 2 "
                          "bf16 replicas (phase 51)": fleet_swap_launches,
                          "gpt2-345m fleet, 2 replica_worker children fp32, "
                          "kill and relaunch (phase 52; counted in the "
                          "children: each child's own count from its "
                          "state, equal to its decode dispatches x 24 "
                          "layers; not in launches, this process's "
                          "count)": fleet_child_launches},
        max_abs_err=timing["max_abs_err"],
        ms=timing["ms"], kernel_ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        pages_per_split=timing["pages_per_split"]),
        dict(
        name="paged_decode_int8", route="cuda",
        source="deepspeed_tpu_torch/csrc/paged_decode.cu",
        replaces="deepspeed_tpu/ops/attention/paged.py:217 "
                 "(quantized=True, the int8-pool arity)",
        launches=(llama_launches["int8"] + gpt2_int8_launches
                  + gpt2_quant_launches["int8"]
                  + llama_launches["quant"]["int8"]),
        launches_by_path={"llama-1b int8 pool": llama_launches["int8"],
                          "gpt2-345m int8 pool": gpt2_int8_launches,
                          "gpt2-345m int8-resident weights, int8 pool":
                              gpt2_quant_launches["int8"],
                          "llama-1b int8-resident weights, int8 pool":
                              llama_launches["quant"]["int8"]},
        max_abs_err=int8_timing["max_abs_err"], ms=int8_timing["ms"],
        kernel_ms=int8_timing["ms"], plain_ms=int8_timing["plain_ms"],
        bound_ms=int8_timing["bound_ms"], bound_by=int8_timing["bound_by"],
        library_ms=int8_timing["library_ms"],
        pages_per_split=int8_timing["pages_per_split"])]
    generate_launches = {"masked_flash_fwd": gpt2_generate_launches
                         + llama_launches["generate"]}
    errs = {"masked_flash_fwd": train_check["o_max_abs_err"],
            "masked_flash_dq": train_check["dq_max_abs_err"],
            "masked_flash_dkv": max(train_check["dk_max_abs_err"],
                                    train_check["dv_max_abs_err"])}
    for name, t in train_timing.items():
        extra = {}
        if name == "masked_flash_fwd":
            # K1 at the s8k dense geometry on the default route (phase 29)
            s8k = flash_timing["s8k"]["flash_fwd"]
            extra["s8k_default_route"] = dict(
                ms=s8k["masked_route_ms"], bound_ms=s8k["bound_ms"],
                bound_by=s8k["bound_by"], library_ms=s8k["library_ms"],
                launches=flash_timing["s8k_entry_point"]["masked_launches"])
        kernels.append(dict(
            name=name, route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/masked_flash.cu",
            replaces=t["replaces"],
            launches=(train_launches[name] + llama_train_launches[name]
                      + ckpt_train_launches[name]
                      + generate_launches.get(name, 0)
                      + offload_launches[name]),
            launches_by_path={
                f"gpt2-345m training ({TRAIN_STEPS} steps)":
                    train_launches[name],
                f"gpt2-345m ZeRO-Offload, {OFFLOAD_DS_CONFIG} (phase 53: "
                f"{OFFLOAD_BATCHES} steps without overlap_comm and "
                f"{OFFLOAD_BATCHES} windows with it)": offload_launches[name],
                f"gpt2-345m ZeRO 2 over NCCL at world 1, {ZERO2_DS_CONFIG}, "
                f"launched by the runner (phase 54, {LAUNCH_STEPS} steps; "
                "counted in the child: not in launches, this process's "
                "count)": launcher_child_launches[name],
                f"llama-1b training, G 4 ({TRAIN_STEPS} steps)":
                    llama_train_launches[name],
                f"gpt2-345m checkpoint save and resume ({CKPT_HALF} + "
                f"{CKPT_HALF} steps, {CKPT_DS_CONFIG})":
                    ckpt_train_launches[name],
                **({f"gpt2_generate, gpt2-345m (one bf16 call, B "
                    f"{GEN_BATCH}, prompts of {GEN_PROMPT})":
                    gpt2_generate_launches,
                    f"llama_generate, llama-1b (one bf16 call, B "
                    f"{GEN_BATCH}, prompts of {GEN_PROMPT})":
                    llama_launches["generate"]}
                   if name == "masked_flash_fwd" else {})},
            max_abs_err=max(errs[name], llama_gqa[name]["max_abs_err"]),
            ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            llama_1b_gqa=llama_gqa[name], **extra))
    bert_errs, fixed_errs, band_errs = (
        {"masked_flash_fwd": row["o_max_abs_err"],
         "masked_flash_dq": row["dq_max_abs_err"],
         "masked_flash_dkv": max(row["dk_max_abs_err"],
                                 row["dv_max_abs_err"])}
        for row in (bert_check, fixed_check, sparse_check))
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name in KPM_NAMES:
        t128, t512 = bert_timing[name][128], bert_timing[name][512]
        kernels.append(dict(
            name=f"{name}_kpm", route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/masked_flash.cu",
            replaces=t128["replaces"], launches=bert_launches[name],
            launches_by_path={
                f"bert-large seq 128 ({BERT_STEPS} steps)":
                    bert_launches[name],
                f"bert-large seq 512 ({BERT_STEPS_512} steps)":
                    bert_launches_512[name],
                f"bert-large sparse fixed seq {SPARSE_SEQ} "
                f"({SPARSE_STEPS} steps)": sparse_launches["fixed"][name],
                f"bert-large sparse bslongformer seq {SPARSE_SEQ} "
                f"({SPARSE_STEPS} steps)":
                    sparse_launches["bslongformer"][name]},
            max_abs_err=max(bert_errs[name], fixed_errs[name]),
            max_abs_err_by_case={"bert-large seq 128": bert_errs[name],
                                 f"sparse fixed walk 16 seq {SPARSE_SEQ}":
                                     fixed_errs[name]},
            ms=t128["ms"],
            kernel_ms=t128["ms"], plain_ms=t128["plain_ms"],
            bound_ms=t128["bound_ms"], bound_by=t128["bound_by"],
            library_ms=t128["library_ms"],
            seq512={k: t512[k] for k in timing_keys},
            sparse_fixed_walk16={
                k: sparse_timing[name]["fixed walk16"][k]
                for k in timing_keys}))
    for name in KPM_NAMES:
        t = sparse_timing[name]["bslongformer walk128"]
        kernels.append(dict(
            name=f"{name}_band", route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/masked_flash.cu",
            replaces=t["replaces"],
            launches=band_launches[name],
            launches_by_path={
                f"masked_flash_attention, {BAND_PATH_SPARSE} at walk "
                f"{BAND_PATH_WALK}, seq {SPARSE_SEQ} (one forward and "
                "backward)": band_launches[name]},
            max_abs_err=band_errs[name], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            other_walks={label: {k: v[k] for k in timing_keys}
                         for label, v in sparse_timing[name].items()
                         if label.startswith("bslongformer")
                         and label != "bslongformer walk128"}))
    v2_errs = {"blocksparse_v2_fwd": v2_check["o_max_abs_err"],
               "blocksparse_v2_dq": v2_check["dq_max_abs_err"],
               "blocksparse_v2_dkv": max(v2_check["dk_max_abs_err"],
                                         v2_check["dv_max_abs_err"])}
    for name in V2_NAMES:
        t = v2_timing[name]
        kernels.append(dict(
            name=name, route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/blocksparse_v2.cu",
            replaces=t["replaces"], launches=v2_launches[name],
            launches_by_path={
                f"SparseSelfAttention with attn_mask seq {SPARSE_SEQ} "
                f"({V2_ITERS} forward and backward)": v2_launches[name]},
            max_abs_err=v2_errs[name], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    banded_errs = {n: max(max(row[f"{key}_max_abs_err"] for key in keys)
                          for row in (banded_check, banded_bert_check))
                   for n, keys in (("banded_fwd", ("o",)),
                                   ("banded_dq", ("dq",)),
                                   ("banded_dkv", ("dk", "dv")))}
    for name in BANDED_NAMES:
        t = legacy_timing[name]
        kernels.append(dict(
            name=name, route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/banded.cu",
            replaces=t["replaces"], launches=legacy_bert_launches[name],
            launches_by_path={
                f"bert-large sparse bslongformer seq {SPARSE_SEQ}, legacy "
                f"dispatch ({SPARSE_STEPS} steps)": legacy_bert_launches[name],
                f"SparseSelfAttention s8k bslongformer, legacy ({V2_ITERS} "
                "forward and backward)": entry_launches["lf"][name],
                f"SparseSelfAttention s8k bigbird, legacy ({V2_ITERS} "
                "forward and backward)": entry_launches["bb"][name]},
            max_abs_err=banded_errs[name], ms=t["ms"], kernel_ms=t["ms"],
            ms_by_instance=t["instances"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            **({"q_tiles_per_split": t["q_tiles_per_split"],
                "gc_split_sweep_ms": legacy_timing["split_sweeps"][name]}
               if name == "banded_dkv" else
               {"kv_tiles_per_split": t["kv_tiles_per_split"],
                "gr_split_sweep_ms": legacy_timing["split_sweeps"][name]})))
    nomask_errs = {"blocksparse_v2_fwd": nomask_check["o_max_abs_err"],
                   "blocksparse_v2_dq": nomask_check["dq_max_abs_err"],
                   "blocksparse_v2_dkv": max(nomask_check["dk_max_abs_err"],
                                             nomask_check["dv_max_abs_err"])}
    for name in V2_NAMES:
        t = legacy_timing[f"{name}_nomask"]
        kernels.append(dict(
            name=f"{name}_nomask", route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/blocksparse_v2.cu",
            replaces=t["replaces"], launches=entry_launches["bb"][name],
            launches_by_path={
                f"SparseSelfAttention s8k bigbird, legacy ({V2_ITERS} "
                "forward and backward)": entry_launches["bb"][name]},
            max_abs_err=nomask_errs[name], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    flash_errs = {"flash_fwd": flash_check["o_max_abs_err"],
                  "flash_dq": flash_check["dq_max_abs_err"],
                  "flash_dkv": max(flash_check["dk_max_abs_err"],
                                   flash_check["dv_max_abs_err"])}
    for name in FLASH_NAMES:
        t = flash_timing[name]
        kernels.append(dict(
            name=name, route="cuda", body=kernel_body(name),
            source="deepspeed_tpu_torch/csrc/flash.cu",
            replaces=t["replaces"], launches=flash_launches[name],
            launches_by_path={
                f"gpt2-345m training, kernel='flash' ({TRAIN_STEPS} steps)":
                    flash_launches[name],
                f"bert-large seq 128, kernel='flash' ({BERT_LEGACY_STEPS} "
                "steps, key-mask arity)": flash_bert_launches[name]},
            max_abs_err=flash_errs[name], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            masked_route_ms=t["masked_route_ms"],
            s8k={k: flash_timing["s8k"][name][k]
                 for k in (*timing_keys, "masked_route_ms")}))
    v1_paths = {  # arity: (phase 33's case, {path: launches})
        "am kpm": ("a", {
            f"SparseSelfAttention with attn_mask seq {SPARSE_SEQ}, v1 "
            f"({V2_ITERS} forward and backward)": v1_launches["attn_mask"]}),
        "kpm": ("b", {
            f"bert-large sparse fixed seq {SPARSE_SEQ}, v1 ({SPARSE_STEPS} "
            "steps)": v1_launches["bert"]}),
        "plain": ("lf", {
            f"SparseSelfAttention s8k {kind}, v1 fallback ({V2_ITERS} "
            "forward and backward)": v1_launches[f"s8k {kind}"]
            for kind in ("lf", "bb")})}
    for arity, (case, paths) in v1_paths.items():
        row = v1_check[case]
        errs = {"bs_fwd": row["o_max_abs_err"], "bs_dq": row["dq_max_abs_err"],
                "bs_dkv": max(row["dk_max_abs_err"], row["dv_max_abs_err"])}
        for name in V1_NAMES:
            t = v1_timing[case][name]
            extra = {} if arity != "plain" else {"s8k_bigbird": {
                k: v1_timing["bb"][name][k]
                for k in (*timing_keys, "row_run_ms")}}
            kernels.append(dict(
                name=f"{name}_{arity.replace(' ', '_')}", route="cuda",
                body=kernel_body(name),
                source="deepspeed_tpu_torch/csrc/blocksparse.cu",
                replaces=f"{t['replaces']}, arity {arity!r}",
                launches=sum(p[name] for p in paths.values()),
                launches_by_path={label: p[name]
                                  for label, p in paths.items()},
                max_abs_err=errs[name], ms=t["ms"], kernel_ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                row_run_ms=t["row_run_ms"], **extra))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def profile_activity_probe(pairs=2, steps=2, decode_steps=8):
    """The profile phases' windows (:func:`device_kernels`) with CUDA
    activity alone against CPU and CUDA activity, in turns on the same
    engines: GPT-2 345M's training step (TRAIN_DS_CONFIG, micro batch 8,
    seq 1024) and its bf16 decode step with 8 requests in flight. One
    row per window (its seconds, busy ms and launches per step, every
    kernel), then one per two windows: whether they name the same
    kernels, the kernels whose launches differ, and the largest change
    of a kernel's ms per step (of those over 0.05 ms) between them,
    which the windows of one kind give as the spread.

        python3 chip_smoke.py --profile-probe
    """
    import itertools
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.inference import Request
    from deepspeed_tpu_torch.models.gpt2 import (GPT2_MEDIUM, gpt2_loss_fn,
                                                 init_gpt2_params)
    from deepspeed_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": nvidia_smi_line()})
    _build.build_all()

    def windows(path, run, n):
        got = []
        for i in range(pairs):
            for cpu in (True, False):
                t0 = time.perf_counter()
                kernels = device_kernels(run, n, cpu=cpu)
                got.append({"phase": "profile_probe", "path": path,
                            "window": len(got),
                            "activities": "cpu+cuda" if cpu else "cuda",
                            "seconds": time.perf_counter() - t0,
                            "busy_ms_per_step": sum(k[1] for k in kernels),
                            "launches_per_step": sum(k[2] for k in kernels),
                            "kernels": {k: [ms, calls]
                                        for k, ms, calls in kernels}})
                emit(got[-1])
        for a, b in itertools.combinations(got, 2):
            ka, kb = a["kernels"], b["kernels"]
            both = set(ka) & set(kb)
            emit({"phase": "profile_probe_pair", "path": path,
                  "windows": [a["window"], b["window"]],
                  "activities": [a["activities"], b["activities"]],
                  "same_kernels": set(ka) == set(kb),
                  "only_in_first": sorted(set(ka) - set(kb)),
                  "only_in_second": sorted(set(kb) - set(ka)),
                  "launch_differences": {k: [ka[k][1], kb[k][1]]
                                         for k in sorted(both)
                                         if ka[k][1] != kb[k][1]},
                  "busy_ratio": b["busy_ms_per_step"]
                  / a["busy_ms_per_step"],
                  "max_kernel_ms_change": max(
                      (abs(kb[k][0] / ka[k][0] - 1) for k in both
                       if ka[k][0] > 0.05), default=None)})

    cfg = gpt2_345m_train_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2_loss_fn(cfg, dtype=torch.bfloat16, deterministic=True),
        model_parameters=init_gpt2_params(cfg, gen),
        config=dict(TRAIN_DS_CONFIG, train_micro_batch_size_per_gpu=8))
    data = {"input_ids": np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (8, 1025)).astype(np.int32)}
    for _ in range(TRAIN_WARMUP):
        engine.train_batch(iter([data]))
    windows("gpt2-345m train_batch", lambda: [
        engine.train_batch(iter([data])) for _ in range(steps)], steps)
    del engine
    torch.cuda.empty_cache()
    serve = InferenceEngine(GPT2_MEDIUM, init_gpt2_params(GPT2_MEDIUM, gen),
                            {}, dtype=torch.bfloat16)
    for i, p in enumerate(make_prompts(GPT2_MEDIUM.vocab_size)[:8]):
        serve.submit(Request(prompt=p, seed=i,
                             max_new_tokens=2 * pairs * decode_steps + 4))
    serve.step()                        # prefill + one decode
    serve.step()
    windows("gpt2-345m decode step", lambda: [
        serve.step() for _ in range(decode_steps)], decode_steps)
    serve.run()
    return 0


if __name__ == "__main__":
    if sys.argv[1:3] == ["--child", "zero2"]:
        sys.exit(zero2_child(sys.argv[3]))
    sys.exit(profile_activity_probe() if sys.argv[1:] == ["--profile-probe"]
             else main())
