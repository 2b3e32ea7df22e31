"""Evaluators of the port (port of ``repro.evals``): the exact-DP terminal
distribution, sampled TV/JSD and mode hits, log Z bounds, and the suite
that runs them during training."""
from .bounds import LogZBoundsEval
from .exact import ExactDistributionEval, make_exact_dp, make_hypergrid_dp
from .sampling import SampledDistributionEval
from .suite import EvalSuite

__all__ = ["EvalSuite", "ExactDistributionEval", "LogZBoundsEval",
           "SampledDistributionEval", "make_exact_dp", "make_hypergrid_dp"]
