"""PyTorch/CUDA port of speech_cloner_tpu (offline clone path).

The JAX package ``speech_cloner_tpu`` stays the reference; this package
mirrors its layout (ops/, nn/, models/, pipeline/, runtime/, data/, apps/)
and public names, and imports neither jax nor any module of the JAX
package. Entry points run on the CUDA card unless the caller asks for the
CPU. The JAX package's one Pallas kernel, the GRU time scan, is a CUDA C++
kernel for sm_90a here (``csrc/gru_scan.cu``, bound in ``ops/cuda_kernels.py``).
"""

__version__ = "0.1.0"
