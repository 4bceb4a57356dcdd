"""kepler-tpu on PyTorch and CUDA: the fleet window's device path.

The counterpart of ``kepler_tpu`` for NVIDIA Hopper cards. The package
mirrors its layout (``ops/``, ``parallel/``, ``fleet/``, ``models/``) so
each module's counterpart is found by path, and it reads and writes the
same wire frames, packed row layout and estimator ``.npz`` files.

The hot kernels of the fleet window (``ops/csrc/attribution.cu``) are
written by hand in CUDA C++ for ``sm_90a``; every kernel keeps a plain
PyTorch version beside it, which serves tensors that lie on the CPU (the
tests) and is the kernel's parity target on the card. Entry points take
``device="cuda"`` by default and raise when CUDA is absent: they run on
the CPU only when the caller asks for it.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
