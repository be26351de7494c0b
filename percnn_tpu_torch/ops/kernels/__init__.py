"""Hand-written CUDA kernels for Hopper, the counterparts of percnn_tpu/ops/pallas.

Each module holds a kernel's Python wrapper, its plain PyTorch version and a
launch counter.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""
