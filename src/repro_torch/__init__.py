"""PyTorch/CUDA port of the automatic loop-offload planner.

Mirrors the layout of the JAX package (``core/``, ``apps/``, ``kernels/``,
``configs/``) and imports nothing from it.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; where CUDA is asked for and
absent they raise (see :func:`repro_torch.core.device.resolve_device`).
"""
