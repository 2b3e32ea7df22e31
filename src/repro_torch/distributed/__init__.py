"""Sharding helpers of the port's execution plans (the plans' part of
``repro.distributed``)."""
