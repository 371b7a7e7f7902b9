"""fruitnerf_tpu_torch — the PyTorch and CUDA port of fruitnerf_tpu.

Mirrors the JAX package's paths module for module; the JAX package stays the
reference and each ported module is held against its twin by
``tests/test_torch_*.py``. Imports ``torch`` and never ``jax``.

Ported so far: the ``fruit_nerf`` preset's ``grid`` variant with its grid in
cell or corner mode, trained end to end by ``engine/trainer.py:train_loop``
with eval metrics (``utils/metrics.py``), checkpoints and the run manifest
(``engine/checkpoints.py``), and a chunked eval render. Every grid encoding
runs hand-written CUDA kernels (``ops/hash_grid.py``,
``csrc/cell_encode.cu``, ``csrc/corner_encode.cu``). ROADMAP.md lists what
is still to port.
"""

__version__ = "0.1.0"
