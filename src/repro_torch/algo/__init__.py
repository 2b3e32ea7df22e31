"""Training loop and samplers of the port (port of ``repro.algo``)."""
from .loop import CapturableLoop, TrainLoop
from .samplers import OnPolicySampler

__all__ = ["CapturableLoop", "OnPolicySampler", "TrainLoop"]
