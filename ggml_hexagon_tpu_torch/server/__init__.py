"""Serving: the continuous-batching engine and the HTTP server."""
from .batch_engine import BatchEngine, Slot, SlotState
