"""The port's hand-written Hopper kernels (CUDA C++ in ``csrc/``).

Each kernel module holds the ctypes wrapper, which launches the kernel for
CUDA tensors and raises on what the kernel does not take, and the plain
PyTorch twin of the same function, which the wrapper runs for CPU tensors
and which tests and ``chip_smoke.py`` hold the kernel against.

    K2  tau_embed.tau_embed         cos-tau embedding, ReLU, Hadamard with phi
    K3  noisy_linear.noisy_linear   factorised NoisyLinear GEMM (+ReLU)
    K4  dueling_head.dueling_head   dueling combine, tau-mean, greedy argmax

``launches`` counts kernel launches by name; ``reset_launches`` zeroes it.
"""

from rainbow_iqn_apex_tpu_torch.kernels.build import launches, reset_launches

__all__ = ["launches", "reset_launches"]
