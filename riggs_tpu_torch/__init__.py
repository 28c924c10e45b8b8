"""riggs_tpu_torch: the rigged-Gaussian system in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``riggs_tpu`` that sits beside it. The layout
mirrors ``riggs_tpu`` file for file (``camera``, ``ops``, ``models``,
``render``, ``eval``, ``data``, ``train``), so each module's counterpart is
found under the same name. The one exception is ``render/pallas_blend.py``,
whose kernels live in ``render/blend.py`` and ``csrc/blend.cu``.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``riggs_tpu``. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; see :mod:`riggs_tpu_torch.device`.
"""
