"""Replay buffers of the port (port of ``repro.buffer``)."""
from .fifo import BufferState, FIFOBuffer

__all__ = ["BufferState", "FIFOBuffer"]
