"""Random sampling operators and the densities of their distributions.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (the ``_random_*``
samplers with fixed parameters and their ``*_like`` forms, the per-row
``_sample_*`` ones, ``_sample_multinomial``, ``_sample_unique_zipfian``
and the ``_random_pdf_*`` densities) and of the four samplers that
``mxnet_tpu/ops/nn.py`` registers (``_random_uniform``, ``_random_normal``,
``_sample_uniform``, ``_sample_normal``), with every alias the reference
registers onto them.

Keys. As in the reference, every sampler takes the RNG key words as a
state binder (``key``, two uint32 words drawn at invoke time from
:func:`mxnet_tpu_torch.random.next_key`), so a sampler called with the
same words draws the same numbers. :func:`generator_for` turns the words
into the generator a draw uses:

- on the CPU, a ``torch.Generator`` seeded from both words mixed into 32
  bits (torch's CPU generator keeps only 32);
- on a CUDA device, that device's one sampler generator (a CUDA
  ``torch.Generator``), reseeded from both words as one 64-bit seed. The
  draw happens on the card; nothing is drawn on the host and copied.

Inside a CUDA graph capture the generator is not reseeded (a capture
cannot change a generator's seed): the graph draws from the generator's
state as it is at each replay. ``CachedOp`` registers the sampler
generator of the capture's device with every graph it captures
(:func:`graph_generators`), so each replay advances it and draws new
numbers, and :func:`mxnet_tpu_torch.random.seed` resets it, so a seed
repeats the sequence of replays that follows it (a call that captures
draws from the generator as the eager run before the capture left it).

Threefry is not ported (ROADMAP C3): the samplers match the reference's
in distribution, not in values. The densities are deterministic and
differentiable, op for op as the reference's.
"""
from __future__ import annotations

import math

import torch

from .core import gammaln as _gammaln_op
from .registry import bind_key, register
from .tensor_extra import _device, _dt

_RNG = {"key": bind_key}
_M32 = 0xFFFFFFFF
_CUDA_GENERATORS = {}


def _words(key):
    return int(key[0]) & _M32, int(key[-1]) & _M32


def generator_for(device, key):
    """The generator a sampler on ``device`` draws from, seeded from the
    key words (see the module docstring)."""
    device = torch.device(device)
    s0, s1 = _words(key)
    if device.type != "cuda":
        return torch.Generator().manual_seed((s0 ^ (s1 * 0x9E3779B9)) & _M32)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    gen = _CUDA_GENERATORS.get(index)
    if gen is None:
        gen = torch.Generator(device=torch.device("cuda", index))
        _CUDA_GENERATORS[index] = gen
    if not torch.cuda.is_current_stream_capturing():
        gen.manual_seed((s0 << 32) | s1)
    return gen


def graph_generators(device):
    """The sampler generators a CUDA graph captured on ``device``
    registers (none until a sampler has run there)."""
    index = torch.device(device).index
    gen = _CUDA_GENERATORS.get(
        torch.cuda.current_device() if index is None else index)
    return () if gen is None else (gen,)


def reseed_devices(seed_state):
    """Reset every device's sampler generator to ``seed_state``."""
    for gen in _CUDA_GENERATORS.values():
        gen.manual_seed(int(seed_state))


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


# ---- the basic draws, in float32 (cast by the callers) ------------------


def _uniform(shape, gen, dev):
    return torch.rand(shape, generator=gen, device=dev)


def _normal(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev)


def _exponential(shape, gen, dev):
    return torch.empty(shape, device=dev).exponential_(generator=gen)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one for each element of ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def _const_like(value, shape, dev):
    return torch.full(shape, float(value), device=dev)


# ---- fixed-parameter samplers (sample_op.cc) -----------------------------


@register("_random_uniform", aliases=("random_uniform", "uniform",
                                      "_npi_uniform"),
          differentiable=False, state_binders=_RNG)
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                    key=None):
    dev = _device(ctx)
    u = _uniform(_shape(shape), generator_for(dev, key), dev)
    return (low + u * (high - low)).to(_dt(dtype))


@register("_random_normal", aliases=("random_normal", "normal",
                                     "_npi_normal"),
          differentiable=False, state_binders=_RNG)
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                   key=None):
    dev = _device(ctx)
    n = _normal(_shape(shape), generator_for(dev, key), dev)
    return (loc + scale * n).to(_dt(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          differentiable=False, state_binders=_RNG)
def _random_exponential(lam=1.0, shape=None, ctx=None, dtype=None,
                        key=None):
    dev = _device(ctx)
    e = _exponential(_shape(shape), generator_for(dev, key), dev)
    return (e / lam).to(_dt(dtype))


@register("_random_gamma", aliases=("random_gamma",), differentiable=False,
          state_binders=_RNG)
def _random_gamma(alpha=1.0, beta=1.0, shape=None, ctx=None, dtype=None,
                  key=None):
    dev = _device(ctx)
    g = _gamma(_const_like(alpha, _shape(shape), dev),
               generator_for(dev, key))
    return (g * beta).to(_dt(dtype))


@register("_random_poisson", aliases=("random_poisson",),
          differentiable=False, state_binders=_RNG)
def _random_poisson(lam=1.0, shape=None, ctx=None, dtype=None, key=None):
    dev = _device(ctx)
    return _poisson(_const_like(lam, _shape(shape), dev),
                    generator_for(dev, key)).to(_dt(dtype))


def _nb(k, p, gen):
    """NB(k, p) = Poisson(Gamma(k) * (1 - p) / p), elementwise."""
    return _poisson(_gamma(k, gen) * ((1 - p) / p), gen)


def _gnb(mu, alpha, gen):
    """GNB(mu, alpha) = Poisson(Gamma(1 / alpha) * mu * alpha)."""
    return _poisson(_gamma(1.0 / alpha, gen) * (mu * alpha), gen)


@register("_random_negative_binomial", aliases=("random_negative_binomial",),
          differentiable=False, state_binders=_RNG)
def _random_negative_binomial(k=1, p=1.0, shape=None, ctx=None, dtype=None,
                              key=None):
    dev = _device(ctx)
    s = _shape(shape)
    return _nb(_const_like(k, s, dev), _const_like(p, s, dev),
               generator_for(dev, key)).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",),
          differentiable=False, state_binders=_RNG)
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                          ctx=None, dtype=None, key=None):
    dev = _device(ctx)
    s = _shape(shape)
    return _gnb(_const_like(mu, s, dev), _const_like(alpha, s, dev),
                generator_for(dev, key)).to(_dt(dtype))


@register("_random_randint", aliases=("random_randint",
                                      "_npi_random_randint"),
          differentiable=False, state_binders=_RNG)
def _random_randint(low=0, high=1, shape=None, ctx=None, dtype=None,
                    key=None):
    dev = _device(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=generator_for(dev, key), device=dev,
                         dtype=_dt(dtype, torch.int32))


# ---- *_like: the data's shape, dtype and device --------------------------


@register("_random_uniform_like", differentiable=False, state_binders=_RNG)
def _random_uniform_like(data, low=0.0, high=1.0, key=None):
    u = _uniform(data.shape, generator_for(data.device, key), data.device)
    return (low + u * (high - low)).to(data.dtype)


@register("_random_normal_like", differentiable=False, state_binders=_RNG)
def _random_normal_like(data, loc=0.0, scale=1.0, key=None):
    n = _normal(data.shape, generator_for(data.device, key), data.device)
    return (loc + scale * n).to(data.dtype)


@register("_random_exponential_like", differentiable=False,
          state_binders=_RNG)
def _random_exponential_like(data, lam=1.0, key=None):
    e = _exponential(data.shape, generator_for(data.device, key),
                     data.device)
    return (e / lam).to(data.dtype)


@register("_random_gamma_like", differentiable=False, state_binders=_RNG)
def _random_gamma_like(data, alpha=1.0, beta=1.0, key=None):
    g = _gamma(_const_like(alpha, data.shape, data.device),
               generator_for(data.device, key))
    return (g * beta).to(data.dtype)


@register("_random_poisson_like", differentiable=False, state_binders=_RNG)
def _random_poisson_like(data, lam=1.0, key=None):
    return _poisson(_const_like(lam, data.shape, data.device),
                    generator_for(data.device, key)).to(data.dtype)


@register("_random_negative_binomial_like", differentiable=False,
          state_binders=_RNG)
def _random_negative_binomial_like(data, k=1, p=1.0, key=None):
    s, dev = data.shape, data.device
    return _nb(_const_like(k, s, dev), _const_like(p, s, dev),
               generator_for(dev, key)).to(data.dtype)


@register("_random_generalized_negative_binomial_like",
          differentiable=False, state_binders=_RNG)
def _random_generalized_negative_binomial_like(data, mu=1.0, alpha=1.0,
                                               key=None):
    s, dev = data.shape, data.device
    return _gnb(_const_like(mu, s, dev), _const_like(alpha, s, dev),
                generator_for(dev, key)).to(data.dtype)


# ---- _sample_*: one distribution per element of the parameters, ``shape``
# draws from each (multisample_op.cc) --------------------------------------


def _per_row(param, shape):
    """``param`` (float32) broadcast to ``param.shape + shape``."""
    s = _shape(shape)
    p = param.float().reshape(tuple(param.shape) + (1,) * len(s))
    return p.expand(tuple(param.shape) + s)


@register("_sample_uniform", aliases=("sample_uniform",),
          differentiable=False, state_binders=_RNG)
def _sample_uniform(low, high, shape=(), dtype="float32", key=None):
    lo, hi = _per_row(low, shape), _per_row(high, shape)
    u = _uniform(lo.shape, generator_for(low.device, key), low.device)
    return (lo + u * (hi - lo)).to(_dt(dtype))


@register("_sample_normal", aliases=("sample_normal",),
          differentiable=False, state_binders=_RNG)
def _sample_normal(mu, sigma, shape=(), dtype="float32", key=None):
    m, s = _per_row(mu, shape), _per_row(sigma, shape)
    n = _normal(m.shape, generator_for(mu.device, key), mu.device)
    return (m + n * s).to(_dt(dtype))


@register("_sample_exponential", aliases=("sample_exponential",),
          differentiable=False, state_binders=_RNG)
def _sample_exponential(lam, shape=None, dtype=None, key=None):
    lm = _per_row(lam, shape)
    e = _exponential(lm.shape, generator_for(lam.device, key), lam.device)
    return (e / lm).to(_dt(dtype))


@register("_sample_gamma", aliases=("sample_gamma",), differentiable=False,
          state_binders=_RNG)
def _sample_gamma(alpha, beta, shape=None, dtype=None, key=None):
    g = _gamma(_per_row(alpha, shape).contiguous(),
               generator_for(alpha.device, key))
    return (g * _per_row(beta, shape)).to(_dt(dtype))


@register("_sample_poisson", aliases=("sample_poisson",),
          differentiable=False, state_binders=_RNG)
def _sample_poisson(lam, shape=None, dtype=None, key=None):
    return _poisson(_per_row(lam, shape).contiguous(),
                    generator_for(lam.device, key)).to(_dt(dtype))


@register("_sample_negative_binomial", aliases=("sample_negative_binomial",),
          differentiable=False, state_binders=_RNG)
def _sample_negative_binomial(k, p, shape=None, dtype=None, key=None):
    return _nb(_per_row(k, shape).contiguous(), _per_row(p, shape),
               generator_for(k.device, key)).to(_dt(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=("sample_generalized_negative_binomial",),
          differentiable=False, state_binders=_RNG)
def _sample_generalized_negative_binomial(mu, alpha, shape=None, dtype=None,
                                          key=None):
    return _gnb(_per_row(mu, shape), _per_row(alpha, shape).contiguous(),
                generator_for(mu.device, key)).to(_dt(dtype))


@register("_sample_multinomial", aliases=("sample_multinomial",),
          differentiable=False, state_binders=_RNG)
def _sample_multinomial(data, shape=None, get_prob=False, dtype=None,
                        key=None):
    """Category draws from the probability rows of ``data`` (its last
    axis): ``shape`` (an int or a 1-tuple) draws a row, or one without it;
    with ``get_prob`` also each draw's log-probability."""
    n = 1
    if shape:
        n = int(shape[0] if isinstance(shape, (list, tuple)) else shape)
    batch = tuple(data.shape[:-1])
    logits = torch.log(torch.clamp(data, min=1e-30))
    probs = data.float().reshape(-1, data.shape[-1])
    draws = torch.multinomial(probs, n, replacement=True,
                              generator=generator_for(data.device, key))
    draws = draws.reshape(batch + (n,))
    out = draws if shape else draws.reshape(batch)
    out = out.to(_dt(dtype, torch.int32))
    if get_prob:
        p = torch.gather(logits, -1, draws)
        return out, p if shape else p.reshape(batch)
    return out


@register("_sample_unique_zipfian", aliases=("sample_unique_zipfian",),
          differentiable=False, n_out=2, state_binders=_RNG)
def _sample_unique_zipfian(range_max=1, shape=None, key=None):
    """Log-uniform (zipfian) draws in ``[0, range_max)`` and each row's
    count of distinct draws, both int64."""
    shape = _shape(shape) or (1,)
    dev = _device(None)
    u = _uniform(shape, generator_for(dev, key), dev)
    draws = torch.exp(u * math.log(float(range_max))).to(torch.int64) % \
        int(range_max)
    rows = torch.sort(draws.reshape(-1, shape[-1]), -1).values
    counts = 1 + (rows[:, 1:] != rows[:, :-1]).sum(-1)
    counts = counts.reshape(shape[:-1] + (1,) if len(shape) > 1 else (1,))
    return draws, counts.to(torch.int64)


# ---- densities (pdf_op.cc): differentiable in the sample and the
# parameters; a parameter array has one fewer trailing axis than the
# sample ------------------------------------------------------------------


def _gammaln(x):
    """The reference's ``gammaln`` (XLA's Lanczos lgamma)."""
    return _gammaln_op.fn(x)


def _pexp(lpdf, is_log):
    return lpdf if is_log else torch.exp(lpdf)


def _nb_lpdf(sample, k, p):
    return (_gammaln(sample + k) - _gammaln(sample + 1)
            - _gammaln(k) + k * torch.log(p)
            + sample * torch.log(1 - p))


@register("_random_pdf_uniform", aliases=("random_pdf_uniform",))
def _random_pdf_uniform(sample, low, high, is_log=False):
    lpdf = -torch.log(high[..., None] - low[..., None]) * \
        torch.ones_like(sample)
    return _pexp(lpdf, is_log)


@register("_random_pdf_normal", aliases=("random_pdf_normal",))
def _random_pdf_normal(sample, mu, sigma, is_log=False):
    u, s = mu[..., None], sigma[..., None]
    expo = -0.5 * (sample - u) ** 2 / (s * s)
    lpdf = expo - torch.log(math.sqrt(2.0 * math.pi) * s)
    return _pexp(lpdf, is_log)


@register("_random_pdf_gamma", aliases=("random_pdf_gamma",))
def _random_pdf_gamma(sample, alpha, beta, is_log=False):
    """Gamma with shape ``alpha`` and rate ``beta``."""
    a, b = alpha[..., None], beta[..., None]
    lpdf = a * torch.log(b) + (a - 1) * torch.log(sample) - b * sample \
        - _gammaln(a)
    return _pexp(lpdf, is_log)


@register("_random_pdf_exponential", aliases=("random_pdf_exponential",))
def _random_pdf_exponential(sample, lam, is_log=False):
    lm = lam[..., None]
    return _pexp(torch.log(lm) - lm * sample, is_log)


@register("_random_pdf_poisson", aliases=("random_pdf_poisson",))
def _random_pdf_poisson(sample, lam, is_log=False):
    lm = lam[..., None]
    lpdf = sample * torch.log(lm) - _gammaln(sample + 1) - lm
    return _pexp(lpdf, is_log)


@register("_random_pdf_negative_binomial",
          aliases=("random_pdf_negative_binomial",))
def _random_pdf_negative_binomial(sample, k, p, is_log=False):
    return _pexp(_nb_lpdf(sample, k[..., None], p[..., None]), is_log)


@register("_random_pdf_generalized_negative_binomial",
          aliases=("random_pdf_generalized_negative_binomial",))
def _random_pdf_generalized_negative_binomial(sample, mu, alpha,
                                              is_log=False):
    """NB with ``k = 1 / alpha`` and ``p = 1 / (mu * alpha + 1)``."""
    kk = 1.0 / alpha[..., None]
    pp = 1.0 / (mu[..., None] * alpha[..., None] + 1.0)
    return _pexp(_nb_lpdf(sample, kk, pp), is_log)


@register("_random_pdf_dirichlet", aliases=("random_pdf_dirichlet",))
def _random_pdf_dirichlet(sample, alpha, is_log=False):
    """``sample`` (..., n, k), ``alpha`` (..., k) -> (..., n)."""
    a = alpha[..., None, :]
    lpdf = (torch.sum((a - 1) * torch.log(sample), -1)
            + _gammaln(torch.sum(a, -1))
            - torch.sum(_gammaln(a), -1))
    return _pexp(lpdf, is_log)
