"""PyTorch/CUDA port of :mod:`sldm_gnn_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
numpy only (never ``jax``, ``flax``, ``pandas``, ``click`` or anything of
``sldm_gnn_tpu``). The GRU forward and the KNN selection, which the JAX
package runs as Pallas kernels, are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_build.py``); every kernel has a plain PyTorch version beside it,
which runs only on CPU tensors.

Float32 matrix products and convolutions run in full float32: TF32 is
switched off for both cuBLAS and cuDNN, so the f32 paths keep the JAX
package's f32 tolerances (cuDNN's TF32 default keeps ~3 digits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
