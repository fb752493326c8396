"""The paper's IR workloads on PyTorch: 2fcNet training, MobileNet and
tinyformer prediction.  Datasets, initial weights and programs are the
reference package's, byte for byte; pretraining and evaluation run with
PyTorch on the workload's device (the GPU unless told otherwise).

    python -m repro_torch.workloads --workload twofc|mobilenet|tinyformer
"""

from .datasets import synthetic_cifar10, synthetic_mnist  # noqa: F401
from .mobilenet import build_mobilenet_prediction_workload  # noqa: F401
from .tinyformer import build_tinyformer_prediction_workload  # noqa: F401
from .twofc import build_twofc_training_workload  # noqa: F401
from .weights import from_reference  # noqa: F401
