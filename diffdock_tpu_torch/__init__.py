"""PyTorch/CUDA port of ``diffdock_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``ops/``, ``diffusion/``,
``geometry/``, ``data/``, ``models/``, ``inference/``, ``train/``,
``cli/``, ``utils/``, ``native.py``) so each module has an obvious
counterpart. It imports ``torch`` and never ``jax``, ``flax`` or anything
of ``diffdock_tpu``; numpy-only helpers it needs are copied, and what the
JAX package takes from flax, msgpack, PyYAML and networkx is written here
in plain Python.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc``
at first use into ``_build/`` (see :mod:`diffdock_tpu_torch.utils.build`).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

DEFAULT_DEVICE = "cuda"
