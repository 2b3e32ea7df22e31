"""Training loop and samplers of the port (port of ``repro.algo``)."""
from .loop import CapturableLoop, TrainLoop
from .samplers import (SAMPLERS, BackwardReplaySampler, EpsilonNoisySampler,
                       OnPolicySampler, ReplaySampler, make_sampler)

__all__ = ["CapturableLoop", "TrainLoop", "SAMPLERS",
           "BackwardReplaySampler", "EpsilonNoisySampler", "OnPolicySampler",
           "ReplaySampler", "make_sampler"]
