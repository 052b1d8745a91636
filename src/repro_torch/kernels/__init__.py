# Hand-written Hopper kernels of the port (CUDA C++ in csrc/, built by
# build.py with nvcc into build/repro_torch/ and bound with ctypes) and
# their plain PyTorch versions (ref.py).  Public surface: ops.py.

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd would record through a forward-only kernel: grad
    mode is on and an input requires grad.  A ctypes launch leaves no
    autograd node, so its output would silently cut the gradient of every
    input; the caller runs the plain version instead (see
    ``transformer.forward``'s ``scan_kernel``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad under grad mode; run the plain version for training "
            f"(forward(..., scan_kernel=False)) or call it under "
            f"torch.no_grad()")
