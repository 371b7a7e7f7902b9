"""Interactive viewer for trained runs (the reference's nerfstudio/viser
viewer equivalent, debug/viewer.py:86-112). Twin of
``fruitnerf_tpu/viewer/__init__.py``."""
from .server import ViewerSession, serve  # noqa: F401
