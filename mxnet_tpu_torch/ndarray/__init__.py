"""NDArray files (counterpart of ``mxnet_tpu.ndarray``): the ``.params`` /
``.nd`` binary container only."""
from .serialization import is_mxnet_binary, load_ndarrays, save_ndarrays

__all__ = ["save_ndarrays", "load_ndarrays", "is_mxnet_binary"]
