"""bayeslms_tpu_torch: the PyTorch/CUDA port of bayeslms_tpu for NVIDIA
Hopper (H100).

The JAX package ``bayeslms_tpu`` is the reference and stays as it is; this
package imports neither it nor JAX. Its kernels are written by hand in CUDA
C++ for sm_90a (``csrc/``), built with nvcc at first use and bound through
ctypes; every kernel has a plain PyTorch twin that runs for CPU tensors.
The port has packed-carry N-best rescoring with the 2-layer LSTM LM
(``rescore.scorer.BatchScorer``) and its training
(``train.loop.Trainer``); ROADMAP.md lists what follows.
"""

from .core.config import ModelConfig, RescoreConfig, TrainConfig
from .core.registry import build_model, init_params

__all__ = ["ModelConfig", "RescoreConfig", "TrainConfig", "build_model",
           "init_params"]
