# Hopper kernels for the compute hot-spots of the dense serving path:
# - saturated tile programs (rmsnorm/rotary/swiglu and the other ten),
#   generated as Triton kernels by repro_torch.core.tritongen;
# - flash attention, hand-written in CUDA C++ (csrc/flash_attention.cu,
#   wrapped by the flash_attention module).
# ops.py = dispatching wrappers; ref.py = plain torch oracles.
from . import ops, ref
from .tile_programs import PROGRAMS, get_tile_op

__all__ = ["ops", "ref", "PROGRAMS", "get_tile_op"]
