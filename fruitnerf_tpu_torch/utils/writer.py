"""Metric writer (JSON lines, optional TensorBoard). Twin of
``fruitnerf_tpu/utils/writer.py``, whose framework-free writer is reused."""
from fruitnerf_tpu.utils.writer import MetricWriter  # noqa: F401  (re-exported)
