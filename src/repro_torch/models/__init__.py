"""The LM tier (port of ``repro.models``): config and the hybrid family."""
