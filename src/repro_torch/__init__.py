"""repro_torch — the PyTorch/CUDA port of ``repro`` (DP solving by pipeline).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``dp/``,
``configs/``, ``models/``, ``serving/``, ``launch/``) and its public names.
Plain tensor code is PyTorch; every kernel that ``repro`` wrote in Pallas
(K1–K8, ``kernels/*.py``) is hand-written CUDA C++ under ``csrc/``, built
with ``nvcc`` at first use.

The device of the data decides the path: a CPU tensor goes through each
kernel's plain PyTorch version, a CUDA tensor through the kernel (or the
call raises). Entry points (``dp.solve``, ``dp.batch_solve``,
``CausalLM.from_seed``, ...) take ``device=`` and default to the card.
"""
