"""Several processes and the guardrails on a card. Every test here is
marked ``cuda`` and skips where no CUDA device is present; the module
imports neither JAX nor the JAX package (the CPU side is held to the
reference in ``tests/test_torch_{dist,guardrails,resume,elastic}.py``)::

    python -m pytest --noconftest -q tests/test_torch_dist_cuda.py

- The backend rule on one card: NCCL for a world of one, gloo for two
  ranks on it; NCCL in a world of one runs the store's all-reduce and a
  barrier; gloo stages a CUDA tensor through the host and gives it back
  on its device.
- Two ranks on one card asked for NCCL fail (NCCL refuses two ranks on
  one device); the test prints the message.
- The dist kvstore's invariants over two processes on CUDA tensors.
- ``GuardedStep`` on the card: a clean run equals the unguarded trainer
  bit for bit, a poisoned step is skipped bitwise, and a guarded step
  makes no more synchronizing calls than an unguarded one.
"""
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import _process

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_backend_rule_on_one_card(card):
    assert _process.choose_backend(1) == \
        ("nccl" if torch.cuda.device_count() >= 1 else "gloo")
    assert _process.choose_backend(torch.cuda.device_count() + 1) == "gloo"


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_world_of_one_all_reduce_and_barrier(card, backend, monkeypatch):
    """The rule's input picks the backend: this host's one rank (NCCL), or
    more ranks declared on it than it has cards (gloo)."""
    from mxnet_tpu_torch import kvstore as kvs
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1" if backend == "nccl" else
                       str(torch.cuda.device_count() + 1))
    got = parallel.initialize("127.0.0.1:%d" % _free_port(), 1, 0)
    try:
        assert got == backend == parallel.backend()
        x = torch.randn(1 << 16, device=card)
        y = kvs._cross_process_allreduce(x)
        assert y.device == x.device and torch.equal(x, y)
        kvs.create("dist_sync").barrier()
        _process.barrier()
    finally:
        _process.destroy()


def test_two_ranks_on_one_card_refuse_nccl(card):
    # each rank told it is alone on its host: the rule picks NCCL, and
    # both ranks take cuda:0
    script = ("import os, torch\n"
              "os.environ['LOCAL_RANK'] = '0'\n"
              "os.environ['LOCAL_WORLD_SIZE'] = '1'\n"
              "from mxnet_tpu_torch import parallel\n"
              "parallel.initialize()\n"
              "t = torch.ones(4, device='cuda')\n"
              "torch.distributed.all_reduce(t)\n"
              "torch.cuda.synchronize()\n"
              "print('all_reduce', t.tolist(), flush=True)\n")
    p = subprocess.run(
        LAUNCH + ["-n", "2", "--coordinator", "127.0.0.1:%d" % _free_port(),
                  sys.executable, "-c", script],
        env=_env(), capture_output=True, text=True, timeout=240)
    lines = [ln for ln in (p.stdout + p.stderr).splitlines()
             if "uplicate" in ln or "NCCL" in ln or "all_reduce" in ln]
    print("two ranks on one card with NCCL: rc %d; %s"
          % (p.returncode, " | ".join(lines[-6:])))
    if torch.cuda.device_count() == 1:
        assert p.returncode != 0


def test_dist_kvstore_invariants_on_cuda_tensors(card):
    p = subprocess.run(
        LAUNCH + ["-n", "2", "--coordinator", "127.0.0.1:%d" % _free_port(),
                  sys.executable,
                  os.path.join(REPO, "tests", "dist_torch",
                               "dist_sync_kvstore_worker.py")],
        env=_env(DIST_DEVICE="cuda"), capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "rank 0 OK" in p.stdout and "rank 1 OK" in p.stdout
    assert "backend gloo" in p.stdout


def _lm_trainer(card):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import TransformerLM
    torch.manual_seed(0)
    net = TransformerLM(512, units=128, num_layers=2, num_heads=2,
                        max_len=128, device=card)
    return parallel.ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "adam",
                                   {"learning_rate": 1e-3}, device=card)


def _batches(card, n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.integers(0, 512, (8, 128))).to(card)
        y = torch.cat([x[:, 1:], torch.full((8, 1), -1, device=card)], 1)
        out.append((x, y.float()))
    return out


def _syncs(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


def test_guarded_step_on_the_card(card):
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.resilience.guardrails import GuardedStep
    batches = _batches(card, 5)
    ref = _lm_trainer(card)
    ref_syncs = []
    for i in (0, 1, 3, 4):
        ref_syncs.append(_syncs(lambda i=i: ref.step(*batches[i])))
    tr = _lm_trainer(card)
    g = GuardedStep(tr, dynamic_scale=True, init_scale=2.0 ** 15,
                    detector=False)
    syncs = []
    chaos.clear()
    chaos.arm("trainer.grads", "nan", at=3)
    try:
        for x, y in batches:
            syncs.append(_syncs(lambda x=x, y=y: g.step(x, y)))
    finally:
        chaos.clear()
    g.flush()
    assert g.skipped_steps == 1 and int(g.opt_step) == 4
    assert g.loss_scale == 2.0 ** 14
    for n, v in ref.values.items():
        assert torch.equal(v, tr.values[n]), n
        for a, b in zip(ref.states[n], tr.states[n]):
            assert torch.equal(a, b), n
    print("syncs a step: guarded %s, unguarded %s" % (syncs, ref_syncs))
    assert all(g <= u for g, u in zip(syncs[:2] + syncs[3:], ref_syncs))
    g.close()
