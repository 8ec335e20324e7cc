"""Config keys and defaults (the port of the training keys, the
``sparse_attention``, ``inference`` and ``observability`` parts of
``deepspeed_tpu/runtime/constants.py``, and of
``deepspeed_tpu/runtime/zero/constants.py``): same names, same defaults,
so one JSON config drives either package.
"""

#############################################
# Batch size (triangle: train_batch_size == micro * grad_acc * world)
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
# the JAX package's TPU spelling; both accepted
TRAIN_MICRO_BATCH_SIZE_PER_CHIP = "train_micro_batch_size_per_chip"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_ADAM = "deepspeed_adam"
SGD_OPTIMIZER = "sgd"
ADAMW_OPTIMIZER = "adamw"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    DEEPSPEED_ADAM, SGD_OPTIMIZER,
]

#############################################
# Steps, precision, clipping, timers
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False
BF16_MASTER_WEIGHTS = "master_weights"
BF16_MASTER_WEIGHTS_DEFAULT = True
BF16_STOCHASTIC_ROUNDING = "stochastic_rounding"
BF16_STOCHASTIC_ROUNDING_DEFAULT = False
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
PIPELINE = "pipeline"
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
MESH = "mesh"
MESH_AXES = "axes"

#############################################
# Sparse attention (runtime/config.py::get_sparse_attention)
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

#############################################
# ZeRO (zero/constants.py)
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = 0
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False

#############################################
# Compressed comms, the async step pipeline and the training trace
# window (read for their value checks only: ROADMAP Queue 1 items 5, 7
# and 13 port their runtime)
#############################################
COMPRESSED_ALLREDUCE = "compressed_allreduce"
COMPRESSED_ALLREDUCE_ENABLED = "enabled"
COMPRESSED_ALLREDUCE_BLOCK = "block"
QUANTIZED_COMM = "quantized_comm"
QUANTIZED_COMM_ENABLED = "enabled"
QUANTIZED_COMM_ENABLED_DEFAULT = False
QUANTIZED_COMM_ALGO = "algo"
QUANTIZED_COMM_ALGO_DEFAULT = "twohop"
QUANTIZED_COMM_BLOCK = "block"
QUANTIZED_COMM_BLOCK_DEFAULT = 256
QUANTIZED_COMM_HIERARCHICAL = "hierarchical"
QUANTIZED_COMM_HIERARCHICAL_DEFAULT = 0
QUANTIZED_COMM_QUANTIZE_WEIGHTS = "quantize_weights"
QUANTIZED_COMM_QUANTIZE_WEIGHTS_DEFAULT = False
QUANTIZED_COMM_SECONDARY_PARTITION = "secondary_partition"
QUANTIZED_COMM_SECONDARY_PARTITION_DEFAULT = False
# the exchanges of runtime/quantized_collectives.py
QUANTIZED_ALGOS = ("twohop", "allgather")
COMM_AUTOTUNE = "comm_autotune"
COMM_AUTOTUNE_ENABLED = "enabled"
COMM_AUTOTUNE_ENABLED_DEFAULT = False
COMM_AUTOTUNE_OVERLAP = "overlap"
COMM_AUTOTUNE_OVERLAP_DEFAULT = "auto"
COMM_AUTOTUNE_CALIBRATE = "calibrate"
COMM_AUTOTUNE_CALIBRATE_DEFAULT = False
COMM_AUTOTUNE_INTRA_SIZE = "intra_size"
COMM_AUTOTUNE_INTRA_SIZE_DEFAULT = 0
COMM_AUTOTUNE_INTRA_GBPS = "intra_gbps"
COMM_AUTOTUNE_INTRA_GBPS_DEFAULT = 75.0
COMM_AUTOTUNE_INTER_GBPS = "inter_gbps"
COMM_AUTOTUNE_INTER_GBPS_DEFAULT = 12.5
COMM_AUTOTUNE_INTRA_LATENCY_US = "intra_latency_us"
COMM_AUTOTUNE_INTRA_LATENCY_US_DEFAULT = 1.0
COMM_AUTOTUNE_INTER_LATENCY_US = "inter_latency_us"
COMM_AUTOTUNE_INTER_LATENCY_US_DEFAULT = 10.0
COMM_AUTOTUNE_BLOCK_CANDIDATES = "block_candidates"
COMM_AUTOTUNE_BLOCK_CANDIDATES_DEFAULT = (64, 128, 256)
ASYNC_PIPELINE = "async_pipeline"
ASYNC_FUSED_ACCUMULATION = "fused_accumulation"
ASYNC_FUSED_ACCUMULATION_DEFAULT = True
ASYNC_PREFETCH_DEPTH = "prefetch_depth"
ASYNC_PREFETCH_DEPTH_DEFAULT = 2
ASYNC_SYNC_LOSS_EVERY_STEP = "sync_loss_every_step"
ASYNC_SYNC_LOSS_EVERY_STEP_DEFAULT = False
# the legacy top-level trace window, aliased into observability.trace
PROFILER = "profiler"
PROFILER_ENABLED = "enabled"
PROFILER_ENABLED_DEFAULT = False
PROFILER_OUTPUT_PATH = "output_path"
PROFILER_OUTPUT_PATH_DEFAULT = "/tmp/deepspeed_tpu_trace"
PROFILER_START_STEP = "start_step"
PROFILER_START_STEP_DEFAULT = 2
PROFILER_NUM_STEPS = "num_steps"
PROFILER_NUM_STEPS_DEFAULT = 3

#############################################
# Observability (the serving part, and the training part's keys)
#############################################
OBSERVABILITY = "observability"
OBS_ENABLED = "enabled"
OBS_ENABLED_DEFAULT = False
OBS_EVENTS_DIR = "events_dir"
OBS_EVENTS_DIR_DEFAULT = "/tmp/deepspeed_tpu_obs"
OBS_FLOPS_PROFILER = "flops_profiler"
OBS_FLOPS_PROFILER_DEFAULT = True
OBS_MEMORY_WATERMARKS = "memory_watermarks"
OBS_MEMORY_WATERMARKS_DEFAULT = True
OBS_RECOMPILE_WARN_AFTER = "recompile_warn_after"
OBS_RECOMPILE_WARN_AFTER_DEFAULT = 1
OBS_TRACE = "trace"
OBS_HEALTH = "health"
OBS_HEALTH_ENABLED = "enabled"
OBS_HEALTH_ENABLED_DEFAULT = False
OBS_HEALTH_RING_EVENTS = "ring_events"
OBS_HEALTH_RING_EVENTS_DEFAULT = 256
OBS_HEALTH_STALL_TIMEOUT_S = "stall_timeout_s"
OBS_HEALTH_STALL_TIMEOUT_S_DEFAULT = 0.0
OBS_HEALTH_ON_STALL = "on_stall"
OBS_HEALTH_ON_STALL_DEFAULT = "warn"
OBS_HEALTH_FLIGHT_PATH = "flight_path"
OBS_HEALTH_FLIGHT_PATH_DEFAULT = ""
OBS_HEALTH_DETECTORS = "detectors"
OBS_HEALTH_DET_ENABLED = "enabled"
OBS_HEALTH_DET_ENABLED_DEFAULT = True
OBS_HEALTH_DET_NONFINITE_STREAK = "nonfinite_streak"
OBS_HEALTH_DET_NONFINITE_STREAK_DEFAULT = 3
OBS_HEALTH_DET_SPIKE_ZSCORE = "spike_zscore"
OBS_HEALTH_DET_SPIKE_ZSCORE_DEFAULT = 6.0
OBS_HEALTH_DET_SPIKE_WINDOW = "spike_window"
OBS_HEALTH_DET_SPIKE_WINDOW_DEFAULT = 32
OBS_HEALTH_DET_GRAD_NORM_MAX = "grad_norm_max"
OBS_HEALTH_DET_GRAD_NORM_MAX_DEFAULT = 1.0e4
OBS_HEALTH_DET_SCALE_COLLAPSE_BELOW = "scale_collapse_below"
OBS_HEALTH_DET_SCALE_COLLAPSE_BELOW_DEFAULT = 2.0
OBS_HEALTH_DET_RECOMPILE_STORM_COUNT = "recompile_storm_count"
OBS_HEALTH_DET_RECOMPILE_STORM_COUNT_DEFAULT = 3
OBS_HEALTH_DET_RECOMPILE_STORM_WINDOW = "recompile_storm_window"
OBS_HEALTH_DET_RECOMPILE_STORM_WINDOW_DEFAULT = 16
OBS_CHROME_TRACE_PATH = "chrome_trace_path"
OBS_CHROME_TRACE_PATH_DEFAULT = ""
# size-based events.jsonl rotation (0 = off): the live file atomically
# rolls to events.jsonl.<n> when it exceeds this many MiB, so a
# long-running (serving) job's event log is bounded per segment;
# tools/obs_report.py reads rotated segments back in order
OBS_EVENTS_MAX_MB = "events_max_mb"
OBS_EVENTS_MAX_MB_DEFAULT = 0
# request-granular serving observability (inference/tracing.py): the
# lifecycle event trail, latency-decomposition histograms, and the
# SLO/goodput split. Host-side and sync-free — on by default (the
# serving engine emits nothing anyway unless inference.events_dir or a
# monitor is wired).
OBS_SERVE = "serve"
OBS_SERVE_ENABLED = "enabled"
OBS_SERVE_ENABLED_DEFAULT = True
OBS_SERVE_SLO = "slo"
OBS_SERVE_SLO_TTFT_MS = "ttft_ms"
OBS_SERVE_SLO_TTFT_MS_DEFAULT = 2000.0    # time to first token budget
OBS_SERVE_SLO_TBT_MS = "tbt_ms"
OBS_SERVE_SLO_TBT_MS_DEFAULT = 200.0      # mean time-between-tokens budget
# serve_decode_window sampling: one window row per request every
# round(1/rate) tokens (deterministic stride, not RNG; 0 disables)
OBS_SERVE_SAMPLE_RATE = "sample_rate"
OBS_SERVE_SAMPLE_RATE_DEFAULT = 0.0625
# per-section override of the rotation cap for the SERVING events log
# (None = inherit the top-level observability.events_max_mb)
OBS_SERVE_EVENTS_MAX_MB = "events_max_mb"
OBS_SERVE_EVENTS_MAX_MB_DEFAULT = None
# fleet identity: which replica this engine serves as. Stamped onto
# every serve-tracer event row (``replica_id``) so the offline fleet
# merger (tools/obs_report.py --fleet) can attribute rows across
# process boundaries. None (the default) omits the field — a
# standalone engine's trail is unchanged.
OBS_SERVE_REPLICA_ID = "replica_id"
OBS_SERVE_REPLICA_ID_DEFAULT = None

#############################################
# Inference serving engine. The schema is the JAX package's; the port
# serves the paged path (paged_kv.enabled: true, attn_kernel "pallas"
# — which selects the hand-written CUDA paged-decode kernels here — or
# "gather"), over a bf16, fp32 or int8 pool, and its engine raises
# NotImplementedError for mesh, chunked_prefill, spec_decode, disagg and
# quantize_weights (deepspeed_tpu_torch/inference/engine.py).
#
# "inference": {
#   "max_batch_size": 8,          # concurrent decode slots
#   "prompt_buckets": [64, 256],  # prompt pad lengths (ascending)
#   "batch_buckets": [1, 8],      # prefill batch pad sizes (ascending)
#   "max_seq_len": 1024,          # KV-cache length (prompt + generated)
#   "max_new_tokens": 128,        # per-request default
#   "temperature": 0.0,           # 0 = greedy (per-request overridable)
#   "top_k": 0,                   # engine-global (compiled-in) filter
#   "eos_token_id": null,         # default stop token
#   "events_dir": "",             # serving events.jsonl ("" disables)
#   "quantize_weights": false,    # qwZ int8 block weight shipping:
#                                 # false | "bf16" (wire-only, eager
#                                 # dequant; true is an alias) | "int8"
#                                 # (int8-RESIDENT weights — compiled
#                                 # programs dequant per block at each
#                                 # matmul, ~2x less weight HBM)
#   "quantize_block": 256,        # qwZ block size
#   "admit_lookahead": 4,         # HOL fix: queue entries scanned for a
#                                 # head that fits (0 = strict FIFO)
#   "paged_kv": {                 # paged/block KV cache (default path;
#                                 # occupancy ~ tokens in flight, not
#                                 # slots x max_len)
#     "enabled": true,            # false = dense slot x max_len cache
#     "page_size": 16,            # tokens per page
#     "num_pages": 0,             # pool size incl. null page; 0 = auto
#                                 # (dense-equivalent worst case)
#     "prefix_cache": true,       # hash-dedup shared prompt prefixes
#     "attn_kernel": "pallas",    # decode attention: the paged-decode
#                                 # kernel (O(live tokens) pool reads;
#                                 # the CUDA kernel in the port) |
#                                 # "gather" (plain stripe path)
#     "decode_page_buckets": [],  # table-width buckets (pages) for the
#                                 # decode dispatch; [] = one program
#                                 # at full pages_per_seq width. More
#                                 # buckets = one decode program per
#                                 # width at warmup; gather fallback
#                                 # bandwidth then scales with the
#                                 # batch's LIVE pages, not max_len
#     "kv_dtype": null,           # pool payload dtype: null = the
#                                 # engine dtype; "int8" = quantized
#                                 # pool (per-token-row fp32 scales
#                                 # ride alongside, dequant in-kernel)
#     "kv_quant_block": 0         # int8 pool scale block over
#                                 # head_dim; 0 = one scale per token
#                                 # row (must divide head_dim)
#   },
#   "mesh": {                     # serving mesh (GSPMD NamedShardings)
#     "axes": {}                  # e.g. {"model": 4}: tensor-parallel
#                                 # prefill/decode over ICI
#   },
#   "chunked_prefill": {          # long-prompt chunked prefill
#     "enabled": false,           # requires paged_kv.enabled; prompts
#                                 # whose suffix exceeds the largest
#                                 # prompt bucket prefill chunk-by-
#                                 # chunk, interleaved with decode
#                                 # (at most one chunk dispatch/step)
#     "chunk_tokens": 256,        # tokens per chunk dispatch (one
#                                 # compiled chunk program per batch
#                                 # bucket — no prompt-bucket ladder)
#     "cp_threshold_tokens": 0    # prompts at least this long run
#                                 # their chunks context-parallel
#                                 # (ring attention over the serving
#                                 # mesh); 0 = off
#   },
#   "spec_decode": {              # speculative multi-token decoding
#     "enabled": false,           # requires paged_kv.enabled
#     "k": 4,                     # max draft tokens proposed/dispatch
#     "method": "ngram",          # "ngram" (prompt-lookup; host-side,
#                                 # no second model) | "callable"
#                                 # (engine-injected small draft model)
#     "ngram_min": 1,             # shortest suffix match tried
#     "ngram_max": 3,             # longest suffix match tried first
#     "verify_widths": []         # compiled verify seq widths;
#                                 # [] = one program at k + 1
#   },
#   "disagg": {                   # disaggregated prefill/decode workers
#     "enabled": false,           # requires paged_kv.enabled
#     "separate_pools": null,     # null = auto (true iff decode_mesh
#                                 # axes set); true forces a prefill
#                                 # pool + priced page handoff
#     "prefill_pages": 0,         # prefill pool size; 0 = auto
#     "decode_mesh": {            # decode worker's own mesh (else the
#       "axes": {}                # decode loop shares inference.mesh)
#     }
#   },
#   "fleet": {                    # multi-replica router (inference/
#                                 # fleet.py FleetRouter)
#     "replicas": 1,              # in-process engine replicas fronted
#     "routing": "least_loaded",  # | "prefix_affinity" (route to the
#                                 # replica whose prefix cache covers
#                                 # the most prompt tokens)
#     "slo_shed": {               # SLO-driven admission (goodput > raw
#                                 # throughput)
#       "enabled": false,
#       "ttft_budget_ms": null,   # p95 TTFT budget; null = the
#                                 # observability.serve.slo.ttft_ms SLO
#       "min_samples": 8,         # TTFTs before the ladder may engage
#       "shed_below_priority": 1, # rung 1: reject requests with
#                                 # priority < this while p95 breaches
#       "degrade_factor": 2.0,    # rung 2 at budget x factor: cap
#                                 # max_new + switch speculation off
#       "degrade_max_new": 32     # the rung-2 max_new cap (0 = no cap)
#     },
#     "swap": {                   # live weight swap (engine.swap_params)
#       "verify_integrity": true  # CRC-verify the tag before pushing
#     }
#   }
# }
#############################################
INFERENCE = "inference"
INF_MAX_BATCH_SIZE = "max_batch_size"
INF_MAX_BATCH_SIZE_DEFAULT = 8
INF_PROMPT_BUCKETS = "prompt_buckets"
INF_PROMPT_BUCKETS_DEFAULT = (64, 256)
INF_BATCH_BUCKETS = "batch_buckets"
INF_BATCH_BUCKETS_DEFAULT = (1, 8)
INF_MAX_SEQ_LEN = "max_seq_len"
INF_MAX_SEQ_LEN_DEFAULT = 1024
INF_MAX_NEW_TOKENS = "max_new_tokens"
INF_MAX_NEW_TOKENS_DEFAULT = 128
INF_TEMPERATURE = "temperature"
INF_TEMPERATURE_DEFAULT = 0.0
INF_TOP_K = "top_k"
INF_TOP_K_DEFAULT = 0
INF_EOS_TOKEN_ID = "eos_token_id"
INF_EOS_TOKEN_ID_DEFAULT = None
INF_EVENTS_DIR = "events_dir"
INF_EVENTS_DIR_DEFAULT = ""
INF_QUANTIZE_WEIGHTS = "quantize_weights"
INF_QUANTIZE_WEIGHTS_DEFAULT = False
INF_QUANTIZE_BLOCK = "quantize_block"
INF_QUANTIZE_BLOCK_DEFAULT = 256
INF_ADMIT_LOOKAHEAD = "admit_lookahead"
INF_ADMIT_LOOKAHEAD_DEFAULT = 4
INF_PAGED_KV = "paged_kv"
INF_PAGED_ENABLED = "enabled"
INF_PAGED_ENABLED_DEFAULT = True
INF_PAGED_PAGE_SIZE = "page_size"
INF_PAGED_PAGE_SIZE_DEFAULT = 16
INF_PAGED_NUM_PAGES = "num_pages"
INF_PAGED_NUM_PAGES_DEFAULT = 0     # 0 = auto (dense-equivalent pool)
INF_PAGED_PREFIX_CACHE = "prefix_cache"
INF_PAGED_PREFIX_CACHE_DEFAULT = True
INF_PAGED_ATTN_KERNEL = "attn_kernel"
INF_PAGED_ATTN_KERNEL_DEFAULT = "pallas"   # "gather" = stripe path
INF_PAGED_DECODE_PAGE_BUCKETS = "decode_page_buckets"
INF_PAGED_DECODE_PAGE_BUCKETS_DEFAULT = ()  # () = one full-width program
INF_PAGED_KV_DTYPE = "kv_dtype"
INF_PAGED_KV_DTYPE_DEFAULT = None   # None = follow the engine dtype
INF_PAGED_KV_QUANT_BLOCK = "kv_quant_block"
INF_PAGED_KV_QUANT_BLOCK_DEFAULT = 0  # 0 = one scale per token row
INF_MESH = "mesh"
INF_MESH_AXES = "axes"
# chunked prefill (long prompts): split prefill into fixed
# chunk_tokens-sized dispatches interleaved with decode steps — TBT
# stays bounded under long prompts, ONE compiled chunk program per
# batch bucket replaces the prompt-bucket ladder for chunked requests,
# and prompts past the largest bucket (up to max_seq_len) serve
# instead of rejecting. cp_threshold_tokens >= chunk-size routes
# chunks of prompts at least that long through the context-parallel
# (ring attention) prefill program over the serving mesh (0 = off).
INF_CHUNKED_PREFILL = "chunked_prefill"
INF_CHUNK_ENABLED = "enabled"
INF_CHUNK_ENABLED_DEFAULT = False
INF_CHUNK_TOKENS = "chunk_tokens"
INF_CHUNK_TOKENS_DEFAULT = 256
INF_CHUNK_CP_THRESHOLD = "cp_threshold_tokens"
INF_CHUNK_CP_THRESHOLD_DEFAULT = 0   # 0 = context-parallel off
INF_SPEC_DECODE = "spec_decode"
INF_SPEC_ENABLED = "enabled"
INF_SPEC_ENABLED_DEFAULT = False
INF_SPEC_K = "k"
INF_SPEC_K_DEFAULT = 4
INF_SPEC_METHOD = "method"
INF_SPEC_METHOD_DEFAULT = "ngram"
INF_SPEC_NGRAM_MIN = "ngram_min"
INF_SPEC_NGRAM_MIN_DEFAULT = 1
INF_SPEC_NGRAM_MAX = "ngram_max"
INF_SPEC_NGRAM_MAX_DEFAULT = 3
INF_SPEC_VERIFY_WIDTHS = "verify_widths"
INF_SPEC_VERIFY_WIDTHS_DEFAULT = ()  # () = one program at k + 1
INF_DISAGG = "disagg"
INF_DISAGG_ENABLED = "enabled"
INF_DISAGG_ENABLED_DEFAULT = False
INF_DISAGG_SEPARATE_POOLS = "separate_pools"
INF_DISAGG_SEPARATE_POOLS_DEFAULT = None  # auto: decode_mesh axes set
INF_DISAGG_PREFILL_PAGES = "prefill_pages"
INF_DISAGG_PREFILL_PAGES_DEFAULT = 0     # 0 = auto
INF_DISAGG_DECODE_MESH = "decode_mesh"
INF_FLEET = "fleet"
INF_FLEET_REPLICAS = "replicas"
INF_FLEET_REPLICAS_DEFAULT = 1
INF_FLEET_ROUTING = "routing"
INF_FLEET_ROUTING_DEFAULT = "least_loaded"
INF_FLEET_ROUTING_CHOICES = ("least_loaded", "prefix_affinity")
INF_FLEET_SLO_SHED = "slo_shed"
INF_FLEET_SHED_ENABLED = "enabled"
INF_FLEET_SHED_ENABLED_DEFAULT = False
INF_FLEET_SHED_TTFT_BUDGET_MS = "ttft_budget_ms"
INF_FLEET_SHED_TTFT_BUDGET_MS_DEFAULT = None  # None = serve SLO ttft_ms
INF_FLEET_SHED_MIN_SAMPLES = "min_samples"
INF_FLEET_SHED_MIN_SAMPLES_DEFAULT = 8
INF_FLEET_SHED_BELOW_PRIORITY = "shed_below_priority"
INF_FLEET_SHED_BELOW_PRIORITY_DEFAULT = 1
INF_FLEET_SHED_DEGRADE_FACTOR = "degrade_factor"
INF_FLEET_SHED_DEGRADE_FACTOR_DEFAULT = 2.0
INF_FLEET_SHED_DEGRADE_MAX_NEW = "degrade_max_new"
INF_FLEET_SHED_DEGRADE_MAX_NEW_DEFAULT = 32  # 0 = no cap
INF_FLEET_SWAP = "swap"
INF_FLEET_SWAP_VERIFY_INTEGRITY = "verify_integrity"
INF_FLEET_SWAP_VERIFY_INTEGRITY_DEFAULT = True
# process-isolated fleet: one engine per child process,
# fronted over the inference/rpc.py channel
INF_FLEET_PROCESS_MODE = "process_mode"
INF_FLEET_PM_ENABLED = "enabled"
INF_FLEET_PM_ENABLED_DEFAULT = False
INF_FLEET_PM_RPC_TIMEOUT_S = "rpc_timeout_s"
INF_FLEET_PM_RPC_TIMEOUT_S_DEFAULT = 120.0
INF_FLEET_PM_RPC_RETRIES = "rpc_retries"
INF_FLEET_PM_RPC_RETRIES_DEFAULT = 2
INF_FLEET_PM_RPC_BACKOFF_S = "rpc_backoff_s"
INF_FLEET_PM_RPC_BACKOFF_S_DEFAULT = 0.05
INF_FLEET_PM_MAX_RESTARTS = "max_restarts"
INF_FLEET_PM_MAX_RESTARTS_DEFAULT = 1
INF_FLEET_PM_RESTART_BACKOFF_S = "restart_backoff_s"
INF_FLEET_PM_RESTART_BACKOFF_S_DEFAULT = 0.5
INF_FLEET_PM_READY_TIMEOUT_S = "ready_timeout_s"
INF_FLEET_PM_READY_TIMEOUT_S_DEFAULT = 300.0
# goodput-driven autoscale: spawn on sustained rung-1
# shedding, retire (drain-via-migration) on sustained idleness
INF_FLEET_AUTOSCALE = "autoscale"
INF_FLEET_AS_ENABLED = "enabled"
INF_FLEET_AS_ENABLED_DEFAULT = False
INF_FLEET_AS_MIN_REPLICAS = "min_replicas"
INF_FLEET_AS_MIN_REPLICAS_DEFAULT = 1
INF_FLEET_AS_MAX_REPLICAS = "max_replicas"
INF_FLEET_AS_MAX_REPLICAS_DEFAULT = 4
INF_FLEET_AS_UP_PATIENCE = "scale_up_patience"
INF_FLEET_AS_UP_PATIENCE_DEFAULT = 4
INF_FLEET_AS_DOWN_PATIENCE = "scale_down_patience"
INF_FLEET_AS_DOWN_PATIENCE_DEFAULT = 64
INF_FLEET_AS_COOLDOWN_STEPS = "cooldown_steps"
INF_FLEET_AS_COOLDOWN_STEPS_DEFAULT = 16
