"""Hand-written Hopper kernels of the port, their wrappers and plain
versions, and the device-backend seam (:mod:`.backend`) the public
wrappers of :mod:`.ops` dispatch through."""

from . import backend

__all__ = ["backend"]
