"""repro_torch — the TPC-H tensor query engine of :mod:`repro`, ported to
PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors ``repro``'s module layout so every module's counterpart is
easy to find, and imports neither ``jax`` nor anything of ``repro``.  The
reference package enables JAX's x64 mode globally; here the same contract is
kept by construction instead: every float column and aggregate is float64 and
every key is int64, with the promotions torch would otherwise narrow to
float32 lifted explicitly (``core/planner.py::_binop``, the avg post-steps in
``core/backend.py``).  ``torch.set_default_dtype`` is never touched.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without CUDA they raise instead of slipping onto the CPU.  On a CPU
tensor each kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches its hand-written Hopper kernel (``kernels/csrc``) or raises.
"""

__version__ = "0.1.0"
