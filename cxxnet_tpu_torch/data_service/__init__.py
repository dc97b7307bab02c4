"""The input data service's wire frames (the rest of the service waits
for ROADMAP Queue A 2)."""

from .wire import WireError, pack_frame, recv_frame

__all__ = ["WireError", "pack_frame", "recv_frame"]
