"""bayeslms_tpu_torch: the PyTorch/CUDA port of bayeslms_tpu for NVIDIA
Hopper (H100).

The JAX package ``bayeslms_tpu`` is the reference and stays as it is; this
package imports neither it nor JAX. Its kernels are written by hand in CUDA
C++ for sm_90a (``csrc/``), built with nvcc at first use and bound through
ctypes; every kernel has a plain PyTorch twin that runs for CPU tensors.
The port scores N-best lists (``rescore.scorer.BatchScorer``: the 2-layer
LSTM LM through the packed-carry layout, or packed-nocarry without
carry-over, the Transformer LM through packed-nocarry, the slotted layouts
for MC-average scoring; interpolated with a second model, backward or
with spliced context; the host encode in one call of the native
tokenizer, ``data/native.py``) and trains both
families (``train.loop.Trainer``: the
standard LSTM of any depth, the GRU and the vanilla RNN, the Bayesian
gate-slice LSTM, the GP-LSTM of every ``l_gauss_pos`` string (GP gates
1-7, GPNN and GPNN2), the variational LSTMs, the standard Transformer, the
Bayesian FFN / MHA / EMB Transformers, the GP-FFN and variational
Transformers; tied or untied decoders; full-state resume and a traced
epoch) and runs the DARTS architecture search (``nas/``); the command line
``bayeslm-torch`` (``cli/main.py``: train, score, rescore, snr, search)
and the lattice rescoring pipeline (``rescore/pipeline.py``) drive them.
ROADMAP.md lists what follows.
"""

from .core.config import ModelConfig, RescoreConfig, TrainConfig
from .core.registry import build_model, init_params

__all__ = ["ModelConfig", "RescoreConfig", "TrainConfig", "build_model",
           "init_params"]
