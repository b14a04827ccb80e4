"""A job of several processes on the CPU (gloo): ``parallel.initialize``
and its backend rule, the ``dist_*`` kvstores across processes, and
``gluon.Trainer`` and ``Module`` over a ``dist_sync`` store; the
counterparts of ``tests/test_dist_multiprocess.py`` and
``tests/dist/test_multihost_local.py``.

The 2-process ``Trainer`` and ``Module`` runs (``tests/dist_torch/
trainer_worker.py``, each rank one half of every global batch) are held to
the port's 2-context runs on logical ``cpu(0)``, ``cpu(1)`` bit for bit
(two gradients summed: the same sum in either order), and to the
reference's 2-context ``gluon.Trainer`` (and one-context ``Module`` on the
whole batch) at the multi-context tests' tolerance. The launcher jobs run
at once in one module fixture (each worker pays a torch import)."""
import contextlib
import os
import socket
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import _process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = os.path.join(REPO, "tests", "dist_torch")
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"]
sys.path.insert(0, DIST)
import trainer_worker  # noqa: E402


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


def _ssh_shim(path):
    path.write_text(
        "#!/bin/sh\n"
        "while true; do\n"
        "  case \"$1\" in\n"
        "    -o) shift 2;;\n"
        "    -n|-q|-T) shift;;\n"
        "    *) break;;\n"
        "  esac\n"
        "done\n"
        "host=\"$1\"; shift\n"
        "exec /bin/sh -c \"$@\"\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """At once: 2 workers (the kvstore invariants, then Trainer and
    Module), 4 kvstore workers, 2 hosts x 2 through the ssh shim, and the
    ssh launcher without a hostfile."""
    base = tmp_path_factory.mktemp("dist")
    kv = os.path.join(DIST, "dist_sync_kvstore_worker.py")
    hostfile = base / "hosts"
    hostfile.write_text("hostA\nhostB\n")
    specs = {
        2: (LAUNCH + ["-n", "2", "--coordinator",
                      "127.0.0.1:%d" % _free_port(), sys.executable,
                      os.path.join(DIST, "trainer_worker.py")],
            _env(DIST_OUT=base, DIST_KVSTORE_CHECKS=1)),
        4: (LAUNCH + ["-n", "4", "--coordinator",
                      "127.0.0.1:%d" % _free_port(), sys.executable, kv],
            _env()),
        "ssh": (LAUNCH + ["-n", "4", "--launcher", "ssh", "-H",
                          str(hostfile), "--coordinator",
                          "127.0.0.1:%d" % _free_port(), sys.executable,
                          kv],
                _env(MXTPU_SSH=_ssh_shim(base / "fake_ssh"))),
        "no_hostfile": (LAUNCH + ["-n", "2", "--launcher", "ssh", "true"],
                        _env()),
    }
    procs = {k: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (cmd, env) in specs.items()}
    out = {"base": base}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[k] = {"rc": p.returncode, "stdout": stdout, "stderr": stderr}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("nproc", [2, 4])
def test_dist_sync_kvstore(jobs, nproc):
    """The dist kvstore's invariants over ``nproc`` processes: pushes
    summed across the workers, pushpull, several keys, a push before init,
    a row set per rank, 2bit compression per worker, the barrier."""
    r = jobs[nproc]
    assert r["rc"] == 0, r["stdout"][-3000:] + r["stderr"][-3000:]
    for rank in range(nproc):
        assert "rank %d OK" % rank in r["stdout"]
        assert "rank %d backend gloo" % rank in r["stdout"]
    assert "backend gloo (the CPU" in r["stdout"]


def test_ssh_launcher_2hosts_x2(jobs):
    r = jobs["ssh"]
    assert r["rc"] == 0, r["stdout"][-3000:] + r["stderr"][-3000:]
    for rank in range(4):
        assert "rank %d OK" % rank in r["stdout"]


def test_ssh_launcher_requires_hostfile(jobs):
    assert jobs["no_hostfile"]["rc"] != 0
    assert "hostfile" in jobs["no_hostfile"]["stderr"]


def _two_context_trainer(pkg, ctxs, store):
    pkg.random.seed(0)
    np.random.seed(0)
    net = pkg.gluon.nn.Dense(4, in_units=3)
    net.initialize(pkg.init.Xavier(), ctx=ctxs)
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore=store)
    xs = [pkg.nd.array(x, ctx=c)
          for x, c in zip(trainer_worker.trainer_inputs(), ctxs)]
    for _ in range(3):
        losses = []
        with pkg.autograd.record():
            for x in xs:
                losses.append((net(x) ** 2).mean())
        for loss in losses:
            loss.backward()
        tr.step(4)
    return {_suffix(n): p.list_data()[0].asnumpy()
            for n, p in net.collect_params().items()}


def _suffix(name):
    """A parameter's name without its block's counted prefix (``dense3_``:
    the count runs per process)."""
    return name.split("_", 1)[1]


def _ranks(jobs, prefix):
    r = [np.load(os.path.join(jobs["base"], "rank%d.npz" % i))
         for i in range(2)]
    return [{_suffix(k[len(prefix):]): z[k] for k in z.files
             if k.startswith(prefix)} for z in r]


def test_dist_gluon_trainer_matches_two_contexts(jobs):
    import mxnet_tpu as jmx
    assert jobs[2]["rc"] == 0, jobs[2]["stderr"][-3000:]
    r0, r1 = _ranks(jobs, "trainer/")
    with tmx.cpu():
        own = _two_context_trainer(tmx, [tmx.cpu(0), tmx.cpu(1)], "device")
    ref = _two_context_trainer(jmx, [jmx.cpu(0), jmx.cpu(1)], "device")
    assert set(r0) == set(own) == set(ref)
    for name, a in own.items():
        b = ref[name]
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
        np.testing.assert_array_equal(r0[name], a, err_msg=name)
        np.testing.assert_allclose(r0[name], b, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _module_run(pkg, ctx, xs, ys):
    np.random.seed(1)
    with tmx.cpu() if pkg is tmx else contextlib.nullcontext():
        mod = pkg.mod.Module(trainer_worker.module_symbol(pkg.sym),
                             context=ctx)
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(pkg.init.Xavier())
        mod.init_optimizer(kvstore="device",
                           optimizer_params=(("learning_rate", 0.1),))
        for i in range(3):
            mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(xs[i])],
                                                  [pkg.nd.array(ys[i])]))
            mod.update()
        return {_suffix(n): v.asnumpy()
                for n, v in mod.get_params()[0].items()}


def test_dist_module_matches_two_contexts(jobs):
    """Each worker binds the half batch: ``rescale_grad`` 1/(4 x 2), the
    store sums both workers' gradients: the 2-context Module's update,
    bit for bit; the reference's one-context Module on the whole batch
    within tolerance."""
    import mxnet_tpu as jmx
    assert jobs[2]["rc"] == 0, jobs[2]["stderr"][-3000:]
    r0, r1 = _ranks(jobs, "module/")
    xs, ys = trainer_worker.module_inputs()
    got = {}
    for pkg, ctx in ((tmx, [tmx.cpu(0), tmx.cpu(1)]), (jmx, jmx.cpu())):
        got[pkg.__name__] = _module_run(pkg, ctx, xs, ys)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
        np.testing.assert_array_equal(r0[name],
                                      got["mxnet_tpu_torch"][name],
                                      err_msg=name)
        np.testing.assert_allclose(r0[name], got["mxnet_tpu"][name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# in this process: a world of one, the backend rule
# ---------------------------------------------------------------------------

def test_initialize_world_of_one_and_dist_store(monkeypatch, capsys):
    monkeypatch.setenv("MXTPU_COORDINATOR", "127.0.0.1:%d" % _free_port())
    monkeypatch.setenv("MXTPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("MXTPU_PROCESS_ID", "0")
    assert parallel.rank() == 0 and parallel.size() == 1
    assert parallel.backend() is None
    assert parallel.initialize() == "gloo"
    try:
        assert "backend gloo" in capsys.readouterr().out
        assert parallel.backend() == "gloo"
        assert parallel.rank() == 0 and parallel.size() == 1
        with pytest.raises(RuntimeError, match="already initialized"):
            parallel.initialize()
        kv = tmx.kv.create("dist_sync")
        assert kv.num_workers == 1 and kv.rank == 0
        with tmx.cpu():
            kv.init("w", nd.ones((3,)))
            out = nd.zeros((3,))
            kv.pushpull("w", nd.ones((3,)) * 2, out=out)
        np.testing.assert_array_equal(out.asnumpy(), [2, 2, 2])
        kv.barrier()
        # a world of one sums through the group too
        before = _process.stats()["allreduce_calls"]
        assert torch.equal(_process.all_reduce(torch.ones(2)),
                           torch.ones(2))
        assert _process.stats()["allreduce_calls"] == before + 1
    finally:
        _process.destroy()
    assert parallel.backend() is None and parallel.size() == 1


def test_backend_rule(monkeypatch):
    """nccl only when every rank on this host has a CUDA device of its
    own; gloo on the CPU and for ranks sharing a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _process.choose_backend(1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _process.choose_backend(1) == "nccl"
    assert _process.choose_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert _process.choose_backend() == "nccl"


def test_dist_async_still_raises_and_features(monkeypatch):
    with pytest.raises(MXNetError, match="dist_async"):
        tmx.kv.create("dist_async")
    assert tmx.runtime.Features().is_enabled("DIST_KVSTORE")
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    with pytest.raises(RuntimeError, match="MXTPU_COORDINATOR"):
        parallel.initialize()
