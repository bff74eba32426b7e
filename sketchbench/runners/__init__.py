"""Runners: each runs the system under one kind of traffic (``traffic/*.json``'s ``runner``)."""
