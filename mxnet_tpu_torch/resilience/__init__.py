"""Fault injection, retry, circuit breaking, resume, guardrails and
elasticity (counterpart of ``mxnet_tpu.resilience``).

- :mod:`.chaos`: named injection points (``chaos.point("generation.step")``)
  armed deterministically from tests or ``MXNET_CHAOS_SPEC``, raising
  :class:`TransientFault` / :class:`FatalFault`, injecting latency, a
  stall, a NaN batch, a lost host or a preemption;
- :mod:`.retry`: :class:`RetryPolicy` (bounded attempts, exponential
  backoff with seeded jitter, a deadline) around the scheduler's step and
  the kvstore;
- :mod:`.breaker`: :class:`CircuitBreaker` (closed / open / half-open)
  behind ``ModelServer``'s ``/generate`` for 503 + ``Retry-After``
  fast-fail and ``/healthz`` degradation;
- :mod:`.resume`: :func:`resumable_fit`, periodic checkpoints with
  restore-and-replay on faults, bitwise equal to an uninterrupted run;
- :mod:`.guardrails`: :class:`GuardedStep`, the branchless NaN skip,
  dynamic loss scaling and clipping on the device, with the host
  :class:`AnomalyDetector` and :class:`StepWatchdog`;
- :mod:`.elastic`: file-rendezvous membership (:class:`ElasticMember`,
  :class:`ElasticCoordinator`), SIGTERM grace-window preemption with
  emergency checkpoints (:class:`PreemptionHandler`, :func:`elastic_fit`)
  and the :class:`CollectiveWatchdog`, driven by ``python -m
  mxnet_tpu_torch.tools.launch --supervise``.

Their counters reach :func:`aggregate_rows`.
"""
# chaos first (no package imports); resume and guardrails import chaos;
# elastic imports resume lazily inside elastic_fit
from .chaos import Fault, TransientFault, FatalFault, SlowFault
from . import chaos
from .retry import (RetryPolicy, RetryExhausted, retryable, named_policy,
                    default_policy)
from . import retry
from .breaker import CircuitBreaker, CircuitOpen
from . import breaker
from .resume import resumable_fit, ResumeGaveUp, resume_stats
from . import resume
from .guardrails import (GuardedStep, AnomalyDetector, StepWatchdog,
                         AnomalyFault)
from . import guardrails
from .elastic import (Preempted, PreemptionHandler, ElasticMember,
                      ElasticCoordinator, CollectiveWatchdog,
                      CollectiveTimeout, elastic_fit)
from . import elastic
from ._stats import aggregate_rows

__all__ = ["chaos", "retry", "breaker", "resume", "guardrails", "elastic",
           "Fault", "TransientFault", "FatalFault", "SlowFault",
           "RetryPolicy", "RetryExhausted", "retryable", "named_policy",
           "default_policy", "CircuitBreaker", "CircuitOpen",
           "resumable_fit", "ResumeGaveUp", "resume_stats",
           "GuardedStep", "AnomalyDetector", "StepWatchdog", "AnomalyFault",
           "Preempted", "PreemptionHandler", "ElasticMember",
           "ElasticCoordinator", "CollectiveWatchdog", "CollectiveTimeout",
           "elastic_fit", "aggregate_rows"]
