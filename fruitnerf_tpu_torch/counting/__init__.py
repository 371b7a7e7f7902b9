"""The counting cascade on the host (numpy, scipy and the native library):
the port's copy of ``fruitnerf_tpu/counting/`` without the JAX device
engine ``dbscan_device.py``, whose branches in ``dbscan.py`` and
``pointcloud.py`` are dropped (both fall through to the exact numpy grid
engine when the native library is missing)."""
