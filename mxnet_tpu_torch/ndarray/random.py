"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``): the
samplers of :mod:`mxnet_tpu_torch.random`."""
from ..random import (bernoulli, exponential, gamma,  # noqa: F401
                      generalized_negative_binomial, multinomial,
                      negative_binomial, normal, poisson, randint, randn,
                      seed, shuffle, uniform)
