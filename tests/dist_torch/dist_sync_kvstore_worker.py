"""A worker of a job of several processes holding the dist kvstore's
invariants (the counterpart of ``tests/dist/dist_sync_kvstore_worker.py``,
after MXNet's ``tests/nightly/dist_sync_kvstore.py``), started by
``python -m mxnet_tpu_torch.tools.launch -n N``.

Each process: init, push a rank-dependent value, pull, and check the pull
against the sum over the workers, several rounds; ``pushpull``; several
keys; a push before ``init``; ``row_sparse_pull`` of a different row set on
each rank; a 2bit-compressed push with error feedback; ``num_dead_node``
and a barrier. ``DIST_DEVICE`` (``cpu`` by default, ``cuda`` on a card)
is where the values live. Prints ``rank <r> OK`` and exits 0.
"""
import os
import sys

import numpy as np


def main():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, parallel
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ndarray import sparse as sp

    device = os.environ.get("DIST_DEVICE", "cpu")
    ctx = mx.gpu(0) if device == "cuda" else mx.cpu()
    nproc = int(os.environ["MXTPU_NUM_PROCESSES"])
    rank = int(os.environ["MXTPU_PROCESS_ID"])

    kv = mx.kv.create("dist_sync")       # joins the launcher's job
    assert parallel.size() == nproc, parallel.size()
    assert kv.num_workers == nproc and kv.rank == rank
    print("rank %d backend %s" % (rank, parallel.backend()), flush=True)

    with ctx:
        shape = (3, 3)
        kv.init("3", nd.ones(shape))
        expected_sum = nproc * (nproc + 1) // 2
        for it in range(1, 4):
            kv.push("3", nd.ones(shape) * (rank + 1) * it)
            out = nd.zeros(shape)
            kv.pull("3", out=out)
            np.testing.assert_allclose(
                out.asnumpy(), np.full(shape, expected_sum * it, np.float32),
                rtol=1e-6, err_msg="iter %d rank %d" % (it, rank))

        val = nd.ones(shape) * (rank + 1)
        kv.pushpull("3", val, out=val)
        np.testing.assert_allclose(val.asnumpy(),
                                   np.full(shape, expected_sum, np.float32))

        kv.init(["a", "b"], [nd.zeros((2,)), nd.zeros((2,))])
        kv.push(["a", "b"], [nd.ones((2,)) * (rank + 1), nd.ones((2,))])
        outs = [nd.zeros((2,)), nd.zeros((2,))]
        kv.pull(["a", "b"], out=outs)
        np.testing.assert_allclose(outs[0].asnumpy(),
                                   np.full((2,), expected_sum, np.float32))
        np.testing.assert_allclose(outs[1].asnumpy(),
                                   np.full((2,), nproc, np.float32))

        try:
            kv.push("never_inited", nd.ones((2,)))
            raise AssertionError("push before init did not raise")
        except MXNetError:
            pass

        # each rank pulls a different row set of the summed value
        kv.init("rs", nd.ones((nproc * 2, 3)))
        kv.push("rs", nd.ones((nproc * 2, 3)) * (rank + 1))
        rows = np.array([rank, rank + nproc], np.int64)
        out_rs = sp.row_sparse_array(
            (np.zeros((2, 3), np.float32), rows), shape=(nproc * 2, 3),
            ctx=ctx)
        kv.row_sparse_pull("rs", out=out_rs, row_ids=nd.array(rows))
        np.testing.assert_allclose(
            out_rs.data.asnumpy(), np.full((2, 3), expected_sum, np.float32),
            err_msg="row_sparse_pull rank %d" % rank)
        np.testing.assert_array_equal(np.sort(out_rs.indices.asnumpy()),
                                      np.sort(rows))

        # every worker compresses its own push: 2.0 quantizes to +0.5
        # whatever the residual, so the store holds nproc * 0.5
        kv2 = mx.kv.create("dist_sync")
        kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv2.init("c", nd.zeros((4,)))
        for _ in range(2):
            kv2.push("c", nd.ones((4,)) * 2.0)
            outc = nd.zeros((4,))
            kv2.pull("c", out=outc)
            np.testing.assert_allclose(
                outc.asnumpy(), np.full((4,), nproc * 0.5, np.float32))
        kv2.push("c", nd.ones((4,)) * -5.0)
        outc = nd.zeros((4,))
        kv2.pull("c", out=outc)
        np.testing.assert_allclose(outc.asnumpy(),
                                   np.full((4,), nproc * -0.5, np.float32))
        assert outc._data.device.type == ("cuda" if device == "cuda"
                                          else "cpu")

    assert kv.num_dead_node == 0
    kv.barrier()
    print("rank %d OK" % rank, flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
