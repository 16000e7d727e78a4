"""PyTorch/CUDA port of the ACC Saturator framework for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro``: the saturator's search
layers are copied (``core``, ``analysis``, ``runtime``); the code
generators emit torch source (``core.torchgen``, the plain version) and
Triton kernels (``core.tritongen``); ``kernels`` holds the hand-written
CUDA flash-attention kernel; ``models`` and ``launch`` serve the dense
decoder family. Imports ``torch``, never ``jax`` or ``repro``.
"""
