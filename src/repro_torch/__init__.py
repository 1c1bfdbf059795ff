"""PyTorch/CUDA port of the OPT-HSFL simulation (``repro`` is the JAX reference).

The layout mirrors ``repro`` module for module, so each file here has a
counterpart of the same path there.  The port imports ``torch`` and numpy
only; modules of ``repro`` that it needs are copied, never imported.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``): there is no
silent CPU fallback.  On a CUDA tensor every kernel wrapper (fused CNN,
delta codec) launches its hand-written kernel (``kernels/*/csrc``); on a
CPU tensor it runs the kernel's plain PyTorch twin (``kernels/*/ref.py``).
"""
