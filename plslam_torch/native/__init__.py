"""Native (C++) host components, bound with ctypes: the prefetching TUM
loader and the PNG decoder the runners read images with (``loader``). The
library builds with ``g++`` at first use; nothing is built at import."""

from .loader import TumLoader, native_available, read_png  # noqa: F401
