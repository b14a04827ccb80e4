"""The ``mod`` namespace (counterpart of ``mxnet_tpu.module``): the
legacy training interface over a Symbol and its Executor."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .sequential_module import PythonModule, SequentialModule

__all__ = ["BaseModule", "BucketingModule", "Module", "PythonModule",
           "SequentialModule"]
