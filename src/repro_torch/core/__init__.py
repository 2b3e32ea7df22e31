"""Core GFlowNet pieces of the port: sampling primitives, policies, rollouts."""
