"""The port's learning-rate schedulers against the JAX package's.

Every scheduler, and the base warm-up in both modes, is called at steps
0..50 in order on both sides; the rates must be equal floats (both are the
same plain Python).
"""
import pytest
import torch

from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu_torch import lr_scheduler as tsched

torch.set_num_threads(1)

CASES = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.1)),
    ("FactorScheduler", dict(step=5, factor=0.9, base_lr=0.1,
                             warmup_steps=6, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[4, 11, 30], factor=0.3,
                                  base_lr=0.2)),
    ("MultiFactorScheduler", dict(step=[10, 20], factor=0.5, base_lr=0.2,
                                  warmup_steps=8, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2)),
    ("PolyScheduler", dict(max_update=8, base_lr=1e-4, pwr=1,
                           warmup_steps=2)),
    ("PolyScheduler", dict(max_update=45, base_lr=0.1, pwr=1.5,
                           final_lr=1e-3, warmup_steps=5,
                           warmup_mode="constant", warmup_begin_lr=1e-3)),
    ("CosineScheduler", dict(max_update=40, base_lr=0.1, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=30, base_lr=0.1, warmup_steps=10,
                             warmup_begin_lr=0.001)),
]


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_scheduler_matches_reference(name, kwargs):
    ref = getattr(jsched, name)(**kwargs)
    own = getattr(tsched, name)(**kwargs)
    assert [own(n) for n in range(51)] == [ref(n) for n in range(51)]


@pytest.mark.parametrize("mode", ["linear", "constant"])
def test_base_warmup_matches_reference(mode):
    ref = jsched.LRScheduler(base_lr=0.5, warmup_steps=20,
                             warmup_begin_lr=0.1, warmup_mode=mode)
    own = tsched.LRScheduler(base_lr=0.5, warmup_steps=20,
                             warmup_begin_lr=0.1, warmup_mode=mode)
    assert [own.get_warmup_lr(n) for n in range(20)] == \
        [ref.get_warmup_lr(n) for n in range(20)]
    with pytest.raises(NotImplementedError):
        own(25)


@pytest.mark.parametrize("kwargs", [dict(base_lr=0.01, warmup_begin_lr=0.1),
                                    dict(warmup_steps=-1),
                                    dict(warmup_mode="cubic")])
def test_refusals_match_reference(kwargs):
    with pytest.raises(ValueError) as ref:
        jsched.LRScheduler(**kwargs)
    with pytest.raises(ValueError) as own:
        tsched.LRScheduler(**kwargs)
    assert str(own.value) == str(ref.value)
