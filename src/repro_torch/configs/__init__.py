"""Architecture configs of the LM tier (port of ``repro.configs``)."""
