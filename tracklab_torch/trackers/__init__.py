"""Trackers of the port: shared slot plumbing and OC-SORT."""
