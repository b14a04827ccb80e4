"""Monitor: counterpart of ``mxnet_tpu/monitor.py``. Installed on an
executor (``Executor.set_monitor_callback``), it collects a statistic
(``stat_func``, the mean absolute value by default) of every operator
output whose name matches ``pattern``, every ``interval`` batches
between :meth:`tic` and :meth:`toc`, and of the bound arguments at
:meth:`toc`."""
from __future__ import annotations

import logging
import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return float(abs(x.asnumpy()).sum() / x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe, monitor_all=False):
        exe.set_monitor_callback(self.stat_helper, monitor_all)
        self.exes.append(exe)

    def stat_helper(self, name, array):
        if not self.activated or not self.re_prog.match(str(name)):
            return
        if isinstance(array, NDArray):
            self.queue.append((self.step, name, self.stat_func(array)))

    def tic(self):
        """Start collecting, on every ``interval``-th batch."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for arr in exe.outputs:
                    arr.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: ``[(step, name, str(stat))]`` collected since
        :meth:`tic`, the bound arguments' included."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, arr in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(arr)))
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        res = [(n, k, str(v)) for n, k, v in self.queue]
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
