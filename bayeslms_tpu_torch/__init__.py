"""bayeslms_tpu_torch: the PyTorch/CUDA port of bayeslms_tpu for NVIDIA
Hopper (H100).

The JAX package ``bayeslms_tpu`` is the reference and stays as it is; this
package imports neither it nor JAX. Its kernels are written by hand in CUDA
C++ for sm_90a (``csrc/``), built with nvcc at first use and bound through
ctypes; every kernel has a plain PyTorch twin that runs for CPU tensors.
The port scores N-best lists (``rescore.scorer.BatchScorer``: the 2-layer
LSTM LM through the packed-carry layout, the Transformer LM through
packed-nocarry) and trains both families (``train.loop.Trainer``: the
standard and Bayesian gate-slice LSTM, the GP-LSTM with GP gates 1-4, the
standard Transformer and the Bayesian FFN / MHA / EMB Transformers);
ROADMAP.md lists what follows.
"""

from .core.config import ModelConfig, RescoreConfig, TrainConfig
from .core.registry import build_model, init_params

__all__ = ["ModelConfig", "RescoreConfig", "TrainConfig", "build_model",
           "init_params"]
