"""PyTorch/CUDA port of the alignq_tpu INT8 serving path.

Mirrors the module paths, function names and keyword names of `alignq_tpu`
so that each function's counterpart is found by name. It never imports JAX
or `alignq_tpu`; the JAX package stays the reference the tests hold it to.

Kernels are CUDA C++ for Hopper (`csrc/`), built with nvcc at first use
(`kernels/_build.py`). Each kernel's wrapper launches it for CUDA tensors
and runs its plain PyTorch version only for CPU tensors.
"""
