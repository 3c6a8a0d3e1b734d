"""GPU compute: limb field arithmetic, NTT, fixed-base MSM, lookup sort and
the constraint-tape interpreter, over 16x16-bit limb tensors.

Each hand-written CUDA kernel (csrc/, built by cuda_kernels.py) sits beside
its plain PyTorch version; a wrapper runs the plain version for a tensor on
the CPU and launches the kernel for a tensor on a CUDA device.
"""
