"""Reward modules of the port."""
