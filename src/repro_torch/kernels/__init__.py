# Hand-written Hopper kernels of the port (CUDA C++ in csrc/, built by
# build.py with nvcc into build/repro_torch/ and bound with ctypes) and
# their plain PyTorch versions (ref.py).  Public surface: ops.py.
