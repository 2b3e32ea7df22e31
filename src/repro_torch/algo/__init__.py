"""Training loop and samplers of the port (port of ``repro.algo``)."""
from .loop import TrainLoop
from .samplers import OnPolicySampler

__all__ = ["OnPolicySampler", "TrainLoop"]
