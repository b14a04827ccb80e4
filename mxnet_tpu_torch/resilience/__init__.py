"""Fault injection, retry and circuit breaking (counterpart of
``mxnet_tpu.resilience``, the subset generation serving uses).

- :mod:`.chaos`: named injection points (``chaos.point("generation.step")``)
  armed deterministically from tests or ``MXNET_CHAOS_SPEC``, raising
  :class:`TransientFault` / :class:`FatalFault` or injecting latency;
- :mod:`.retry`: :class:`RetryPolicy` (bounded attempts, exponential
  backoff with seeded jitter, a deadline) around the scheduler's step;
- :mod:`.breaker`: :class:`CircuitBreaker` (closed / open / half-open)
  behind ``ModelServer``'s ``/generate`` for 503 + ``Retry-After``
  fast-fail and ``/healthz`` degradation.

Their counters reach :func:`aggregate_rows`. Resume, guardrails and
elasticity are not ported.
"""
from .chaos import Fault, TransientFault, FatalFault, SlowFault
from . import chaos
from .retry import (RetryPolicy, RetryExhausted, retryable, named_policy,
                    default_policy)
from . import retry
from .breaker import CircuitBreaker, CircuitOpen
from . import breaker
from ._stats import aggregate_rows

__all__ = ["Fault", "TransientFault", "FatalFault", "SlowFault", "chaos",
           "RetryPolicy", "RetryExhausted", "retryable", "named_policy",
           "default_policy", "retry", "CircuitBreaker", "CircuitOpen",
           "breaker", "aggregate_rows"]
