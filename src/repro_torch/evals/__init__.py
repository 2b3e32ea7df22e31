"""Evaluators of the port (port of ``repro.evals``): the exact-DP terminal
distribution, sampled TV/JSD and mode hits, the reward correlation over a
probe, log Z bounds, and the suite that runs them during training."""
from .bounds import LogZBoundsEval
from .exact import (ExactDistributionEval, make_bitseq_dp, make_exact_dp,
                    make_hypergrid_dp)
from .sampling import (RewardCorrelationEval, SampledDistributionEval,
                       uniform_probe_states)
from .suite import EvalSuite

__all__ = ["EvalSuite", "ExactDistributionEval", "LogZBoundsEval",
           "RewardCorrelationEval", "SampledDistributionEval",
           "make_bitseq_dp", "make_exact_dp", "make_hypergrid_dp",
           "uniform_probe_states"]
