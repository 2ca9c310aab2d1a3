"""PyTorch/CUDA port of MoePhoto-TPU (``moephoto_tpu``), for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
tree and names, keeps its NHWC layout at public functions, and runs its
TPU kernels as hand-written CUDA kernels (``csrc/``).  Entry points run
on the card unless ``config.device`` asks for the CPU.
"""
