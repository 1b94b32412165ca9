"""shafa_tpu_torch — the Shafa codec on PyTorch and CUDA (NVIDIA H100).

A port of shafa_tpu, which stays the reference. The package stands alone:
it imports nothing of shafa_tpu and never imports jax. It keeps its own
copies of the host layers it runs (each names its original):

  errors / geometry / formats / codes / oracle / runtime/
             host format ABI, code tables, the NumPy reference and its C++
             helpers (built with g++ at first use, pure Python without one)
  pipeline   the stages F, T, C, D, resident and (above 256 MiB) streaming
  kernels/   the device stages; K1-K7 are CUDA C++ kernels for sm_90a
             (kernels/csrc/), each beside its plain PyTorch version
  device     TorchBackend: batching, routing, the fused F->C and D tiers
  cli        python -m shafa_tpu_torch, flag-compatible with shafa_tpu

Importing the package needs neither CUDA nor a compiler: the kernels build
with nvcc at first use on the card.
"""

__version__ = "0.1.0"
