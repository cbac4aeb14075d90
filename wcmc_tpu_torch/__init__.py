"""wcmc_tpu_torch — PyTorch/CUDA port of ``wcmc_tpu`` for NVIDIA Hopper.

The JAX package ``wcmc_tpu`` is the reference this port is held
against; each module here keeps the relative name of its counterpart
there.  The port imports ``torch``, numpy and scipy only — never JAX or
anything under ``wcmc_tpu``.

Public layouts follow the reference (channels-last):

* pixel-space tensors:  ``(B, H, W, C)``
* sample-space tensors: ``(B, S, H, W, C)``

Convolutions run internally in NCHW logical order with channels-last
memory (a permuted view of the NHWC tensors, no copy), which is also the
layout cuDNN prefers for bf16.

The TPU kernels of the ported paths (serving and the manifold training
step of KPCN and of LBMC) are hand-written CUDA C++ for ``sm_90a`` under
``ops/csrc`` (built at first use by ``ops/_build.py``); each has a plain
PyTorch version beside it that runs for CPU tensors.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
