"""Replica placement for the serving fleet (port of the serving part of
``repro.sharding``)."""
