"""Module API (ref: python/mxnet/module/__init__.py): the port's copy of
``mxnet_tpu/module/``, on one device."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
