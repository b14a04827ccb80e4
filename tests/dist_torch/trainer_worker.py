"""A worker of a 2-process job (``python -m mxnet_tpu_torch.tools.launch
-n 2``) training through a ``dist_sync`` store: the counterpart, across
processes, of the multi-context ``gluon.Trainer`` and ``Module`` runs of
``tests/test_torch_multi_context.py`` and ``test_torch_module.py``.

Rank r takes the r-th half of each global batch:

- ``gluon.Trainer``: ``Dense(4, in_units=3)`` from ``Xavier()`` at seed 0,
  SGD lr 0.1 momentum 0.9, loss ``(net(x) ** 2).mean()``, ``step(4)`` (the
  global batch), 3 steps;
- ``Module``: ``FullyConnected(3)`` + ``SoftmaxOutput`` bound at the half
  batch 4 (``rescale_grad`` 1/(4 x num_workers)), SGD lr 0.1, 3 batches.

With ``DIST_KVSTORE_CHECKS=1`` it first runs
``dist_sync_kvstore_worker.py``'s invariants. Writes
``$DIST_OUT/rank<r>.npz`` (the Trainer's parameters under ``trainer/``,
the Module's under ``module/``) and prints ``rank <r> OK``.
"""
import os
import sys

import numpy as np


def trainer_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 3)).astype("float32") for _ in range(2)]


def module_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 6)).astype("float32")
    y = rng.integers(0, 3, (3, 8)).astype("float32")
    return x, y


def module_symbol(S):
    net = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
    return S.SoftmaxOutput(net, S.var("softmax_label"), name="softmax")


def main():
    rank = int(os.environ["MXTPU_PROCESS_ID"])
    if os.environ.get("DIST_KVSTORE_CHECKS") == "1":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import dist_sync_kvstore_worker
        dist_sync_kvstore_worker.main()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    out = {}
    with mx.cpu():
        mx.random.seed(0)
        np.random.seed(0)
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9},
                              kvstore="dist_sync")
        x = nd.array(trainer_inputs()[rank])
        for _ in range(3):
            with autograd.record():
                loss = (net(x) ** 2).mean()
            loss.backward()
            tr.step(4)
        assert tr._kvstore.num_workers == 2
        for name, p in net.collect_params().items():
            out["trainer/" + name] = p.data().asnumpy()

        xs, ys = module_inputs()
        np.random.seed(1)
        mod = mx.mod.Module(module_symbol(mx.sym), context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(kvstore="dist_sync",
                           optimizer_params=(("learning_rate", 0.1),))
        assert mod._optimizer.rescale_grad == 1.0 / 8
        half = slice(4 * rank, 4 * rank + 4)
        for i in range(3):
            batch = mx.io.DataBatch([nd.array(xs[i][half])],
                                    [nd.array(ys[i][half])])
            mod.forward_backward(batch)
            mod.update()
        args, _ = mod.get_params()
        for name, v in args.items():
            out["module/" + name] = v.asnumpy()
    np.savez(os.path.join(os.environ["DIST_OUT"], "rank%d.npz" % rank), **out)
    print("rank %d OK" % rank, flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
