"""Core GFlowNet pieces of the port: sampling primitives, policies,
rollouts, objectives and the trainer's config, optimizer and loss."""
