"""The paper's own DNN: ~130 kB MLP trained on an MNIST-class task.

H²-Fed (Sec. VI) federates "a DNN model with a size of 130kB" on MNIST
(10 labels, treated as road-traffic scenario classes).  A 784-40-10 MLP is
31.8k fp32 params = 127 kB — matching the stated size.  Used by fedsim /
examples / paper-figure benchmarks.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MLPTaskConfig:
    name: str = "mnist-mlp"
    source: str = "H2-Fed Sec. VI (130 kB DNN on MNIST)"
    input_dim: int = 784
    hidden_dims: Tuple[int, ...] = (40,)
    n_classes: int = 10


CONFIG = MLPTaskConfig()
