"""PyTorch/CUDA port of the ENEAC reproduction (``repro``).

The layout mirrors ``repro``: :mod:`repro_torch.configs`,
:mod:`repro_torch.core` and :mod:`repro_torch.kernels` hold the
counterparts of the modules of the same names.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.  The hand-written
kernels under ``csrc/`` are compiled with ``nvcc`` at their first launch
(:mod:`repro_torch._build`), so importing the package needs neither a card
nor a CUDA toolkit.
"""
