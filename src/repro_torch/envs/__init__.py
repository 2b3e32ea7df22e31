"""Environments of the port."""
