"""repro_torch — the PyTorch/CUDA port of ``repro`` (DP solving by pipeline).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``dp/``) and
its public names. Plain tensor code is PyTorch; the two pipeline kernels of
the main path (``kernels/sdp_pipeline.py``, ``kernels/mcm_pipeline.py``) are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.

The device of the data decides the path: a CPU tensor goes through each
kernel's plain PyTorch version, a CUDA tensor through the kernel (or the
call raises). Entry points (``dp.solve``, ``dp.batch_solve``, ...) take
``device=`` and default to the card.
"""
