"""Command-line tools of the port: ``launch`` (``python -m
mxnet_tpu_torch.tools.launch``), the counterpart of ``tools/launch.py``."""
