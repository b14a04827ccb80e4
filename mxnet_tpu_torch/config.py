"""Environment-variable knobs the port reads.

Counterpart of ``mxnet_tpu/config.py``: the same ``MXNET_*`` names and
defaults, for only the knobs that the port's modules read: the core
runtime (engine, CachedOp), serving (``/predict`` and generation), the
resilience stack, the tracer, the data path, the sharding planner and
the subgraph backend.
:func:`get` is a typed read of the environment, so a knob set after import
takes effect at its next read.
"""
from __future__ import annotations

import os

__all__ = ["get", "KNOBS"]


class Knob:
    __slots__ = ("name", "default", "typ", "doc")

    def __init__(self, name, default, typ, doc):
        self.name = name
        self.default = default
        self.typ = typ
        self.doc = doc


def _k(name, default, typ, doc):
    return name, Knob(name, default, typ, doc)


KNOBS = dict([
    _k("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
       "NaiveEngine = synchronize after every op for debugging (engine.py)"),
    _k("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", 15, int,
       "bulk-dispatch span size hint (engine.py bulk context)"),
    _k("MXNET_CACHED_OP_CAPACITY", 64, int,
       "max signatures retained per CachedOp (LRU; <=0 means unbounded): "
       "bounds the CUDA graphs and their memory under shape churn"),
    _k("MXNET_WARMUP_THREADS", 4, int,
       "InferenceEngine warmup concurrency: bucket rungs run on a thread "
       "pool this wide (<=1 = serial; CUDA-graph captures serialize on the "
       "CachedOp's lock)"),
    _k("MXNET_HTTP_MAX_BODY", 8 * 1024 * 1024, int,
       "ModelServer POST body cap in bytes: a larger client-declared "
       "Content-Length is refused with 413; <= 0 disables the cap"),
    _k("MXNET_GEN_SLOTS", 8, int,
       "generation serving: KV-cache arena slots == max sequences decoded "
       "per step (serving/generation/kvcache.py)"),
    _k("MXNET_GEN_MAX_SEQ", 256, int,
       "generation serving: per-slot KV capacity (prompt + generated), "
       "capped to the model's max_len"),
    _k("MXNET_GEN_LADDER", "16,32,64,128", str,
       "generation serving: prefill bucket ladder (comma-separated rungs; "
       "prompts pad up to a rung)"),
    _k("MXNET_GEN_MAX_NEW_TOKENS", 128, int,
       "generation serving: default per-request token budget"),
    _k("MXNET_GEN_TOP_K", 0, int,
       "generation serving: top-k sampling filter (0 = off; per-request "
       "temperature stays dynamic)"),
    _k("MXNET_GEN_QUEUE_SIZE", 64, int,
       "generation serving: waiting-request bound before ServerBusy "
       "backpressure (serving/generation/scheduler.py)"),
    _k("MXNET_GEN_PREFILL_CHUNK", 0, int,
       "generation serving: chunked-prefill size: long prompts are split "
       "into chunks of this many tokens interleaved with decode "
       "iterations (0 = monolithic prefill)"),
    _k("MXNET_GEN_PREFIX_CACHE", 1, int,
       "generation serving: copy-on-admit prefix KV cache: admits whose "
       "prompt starts with a cached prefix copy its slab into their slot "
       "and skip that many prefill tokens "
       "(serving/generation/prefix_cache.py; 0 = off)"),
    _k("MXNET_GEN_PREFIX_BLOCK", 32, int,
       "prefix cache sharing granularity: prefixes are stored and probed "
       "at multiples of this many tokens"),
    _k("MXNET_GEN_PREFIX_CACHE_MB", 256, int,
       "prefix cache slab-byte budget; exceeding it LRU-evicts entries "
       "whose refcount is zero (<= 0 disables the bound)"),
    _k("MXNET_GEN_SPEC_K", 4, int,
       "speculative decoding: draft tokens proposed per verify step "
       "(serving/generation/speculative.py)"),
    _k("MXNET_GEN_LANE", "mixed", str,
       "generation lane policy: 'mixed', 'prefill' (requests retire after "
       "the first token and publish their prompt K/V to the prefix cache) "
       "or 'decode' (admits expect prefix-cache coverage; misses are "
       "counted as decode_lane_misses)"),
    _k("MXNET_CHAOS_SPEC", "", str,
       "fault-injection spec armed at import (resilience/chaos.py): "
       "'point:kind[:trigger];...' e.g. generation.step:transient:first=2"),
    _k("MXNET_RETRY_MAX_ATTEMPTS", 3, int,
       "default RetryPolicy total attempts (resilience/retry.py)"),
    _k("MXNET_RETRY_BASE_DELAY_MS", 10.0, float,
       "default RetryPolicy first backoff delay"),
    _k("MXNET_RETRY_MAX_DELAY_MS", 1000.0, float,
       "default RetryPolicy backoff cap"),
    _k("MXNET_RETRY_DEADLINE_MS", 0.0, float,
       "default RetryPolicy wall-clock budget across attempts (0 = none)"),
    _k("MXNET_BREAKER_FAILURE_THRESHOLD", 5, int,
       "serving circuit breaker: consecutive failures before opening "
       "(resilience/breaker.py; <= 0 disables the ModelServer breaker)"),
    _k("MXNET_BREAKER_RECOVERY_MS", 1000.0, float,
       "serving circuit breaker: open-state hold before half-open probes"),
    _k("MXNET_BREAKER_HALF_OPEN_PROBES", 1, int,
       "serving circuit breaker: successful probes required to close"),
    _k("MXNET_RESUME_EVERY", 10, int,
       "resumable_fit checkpoint cadence in steps (resilience/resume.py)"),
    _k("MXNET_GUARDRAILS_CLIP_NORM", 0.0, float,
       "GuardedStep global-norm gradient clip inside the step "
       "(resilience/guardrails.py; 0 = off)"),
    _k("MXNET_GUARDRAILS_DYNAMIC_SCALE", 0, int,
       "GuardedStep dynamic loss scaling as device state (grow/halve; "
       "needed for true fp16, off for bf16/f32)"),
    _k("MXNET_GUARDRAILS_INIT_SCALE", 2.0 ** 16, float,
       "initial loss scale when dynamic scaling is on (the reference AMP "
       "LossScaler default)"),
    _k("MXNET_GUARDRAILS_SCALE_FACTOR", 2.0, float,
       "loss-scale grow/halve factor (a power of 2 keeps fp32 exact)"),
    _k("MXNET_GUARDRAILS_SCALE_WINDOW", 2000, int,
       "consecutive clean steps before the loss scale grows"),
    _k("MXNET_GUARDRAILS_DEADLINE_MS", 0.0, float,
       "GuardedStep watchdog: flag steps whose results are not ready "
       "within this many ms (0 = no watchdog)"),
    _k("MXNET_GUARDRAILS_STORM_WINDOW", 20, int,
       "AnomalyDetector NaN-storm window (recent steps considered)"),
    _k("MXNET_GUARDRAILS_STORM_SKIPS", 5, int,
       "skipped steps within the storm window that declare a NaN storm "
       "(raises AnomalyFault -> resumable_fit restore-and-replay)"),
    _k("MXNET_ELASTIC_HEARTBEAT_MS", 1000.0, float,
       "ElasticMember background-beater cadence (resilience/elastic.py); "
       "per-step beats fire regardless"),
    _k("MXNET_ELASTIC_DEADLINE_MS", 15000.0, float,
       "missed-beat deadline after which the coordinator/supervisor "
       "declares a host dead"),
    _k("MXNET_ELASTIC_GRACE_MS", 10000.0, float,
       "SIGTERM->eviction grace window: the emergency checkpoint must "
       "publish within this budget (PreemptionHandler)"),
    _k("MXNET_ELASTIC_MAX_RESTARTS", 2, int,
       "launcher --supervise: consecutive crash-restarts per worker "
       "before it is evicted and the world re-forms at world-1"),
    _k("MXNET_ELASTIC_BACKOFF_MS", 500.0, float,
       "launcher --supervise: first restart backoff (doubles per "
       "consecutive failure of the same worker)"),
    _k("MXNET_ELASTIC_MIN_WORLD", 1, int,
       "launcher --supervise: smallest world size worth re-forming to; "
       "below it the run fails"),
    _k("MXNET_ELASTIC_COLLECTIVE_DEADLINE_MS", 0.0, float,
       "collective watchdog: abort a kvstore all-reduce/barrier or a "
       "guarded dispatch still blocked after this many ms (hung peer -> "
       "CollectiveTimeout; 0 = off)"),
    _k("MXNET_TRACE_ENABLE", 0, int,
       "record host-side spans from import (observability/tracer.py)"),
    _k("MXNET_TRACE_BUFFER", 65536, int,
       "span ring-buffer capacity in events; a full buffer drops the "
       "oldest record"),
    _k("MXNET_CPU_WORKER_NTHREADS", 1, int,
       "host-side worker threads: DataLoader default num_workers and the "
       "native IO pump decode pool"),
    _k("MXNET_DATALOADER_MAX_SKIPS", 100, int,
       "DataLoader error_policy='skip': bad samples tolerated per "
       "iteration before failing loudly (<0 = unbounded)"),
    _k("MXNET_DATAFEED_DEPTH", 4, int,
       "DeviceFeed staging ring depth: batches copied to the device ahead "
       "of consumption (parallel/datafeed.py)"),
    _k("MXNET_DATAFEED_CHUNK", 8, int,
       "ShardedTrainer.step_stream steps per chunk: the chaos point fires "
       "once per chunk, and the feed stages ahead while a chunk computes"),
    _k("MXNET_PLAN_HBM_BYTES", 0, int,
       "sharding planner per-device memory budget: placements whose "
       "modeled params+optimizer+activation bytes/device exceed it are "
       "infeasible (parallel/planner.py; 0 = unconstrained)"),
    _k("MXNET_PLAN_MAX_PP", 0, int,
       "sharding planner cap on the pipeline factor (0 = no cap)"),
    _k("MXNET_PLAN_FORCE", "", str,
       "bypass the placement search with an explicit plan, e.g. "
       "'dp=2,pp=2,ep=2' (still validated against the model profile)"),
    _k("MXNET_SERVE_PLAN_HBM_BYTES", 0, int,
       "serving planner per-device memory budget (weights + activations "
       "+ KV arena; 0 = unconstrained)"),
    _k("MXNET_SERVE_PLAN_MAX_PP", 0, int,
       "serving planner cap on the pipeline factor (0 = no cap)"),
    _k("MXNET_SERVE_PLAN_FORCE", "", str,
       "bypass the serving placement search with an explicit plan, e.g. "
       "'dp=1,ep=8' (still validated)"),
    _k("MXNET_SUBGRAPH_BACKEND", "NONE", str,
       "partition every bound Symbol with this registered subgraph "
       "backend (symbol/subgraph.py; NONE = off)"),
    _k("MXNET_FLASH_ATTENTION", 1, int,
       "dispatch dot_product_attention to the CUDA flash-attention kernel "
       "when its gate holds (ops/nn.py; 0 = always take the plain path)"),
])


def get(name, default=None):
    """Typed env read. Unknown names fall back to raw ``os.environ``."""
    knob = KNOBS.get(name)
    raw = os.environ.get(name)
    if knob is None:
        return raw if raw is not None else default
    if raw is None:
        return knob.default if default is None else default
    try:
        return knob.typ(raw)
    except (TypeError, ValueError):
        return knob.default
