"""Tensor ops of the port: boxes, assignment, Kalman filters, NMS."""
