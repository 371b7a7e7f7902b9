"""fruitnerf_tpu_torch — the PyTorch and CUDA port of fruitnerf_tpu.

Mirrors the JAX package's paths module for module; the JAX package stays the
reference and each ported module is held against its twin by
``tests/test_torch_*.py``. Imports ``torch`` and never ``jax``, nor anything
of ``fruitnerf_tpu``: the framework-free code it needs from there (counting,
the native library, ``.ply`` IO, the metric writer, the numpy scene, the CLI
flags) is its own copy. Its entry points run on the card unless the caller
asks for the CPU.

Ported so far: the ``fruit_nerf`` preset's ``grid`` variant with its grid in
cell or corner mode, trained end to end by ``engine/trainer.py:train_loop``
with eval metrics (``utils/metrics.py``), checkpoints and the run manifest
(``engine/checkpoints.py``), a chunked eval render, volume export and the
fruit-counting CLI (``scripts/``). Every grid encoding
runs hand-written CUDA kernels (``ops/hash_grid.py``,
``csrc/cell_encode.cu``, ``csrc/corner_encode.cu``). ROADMAP.md lists what
is still to port.
"""

__version__ = "0.1.0"
