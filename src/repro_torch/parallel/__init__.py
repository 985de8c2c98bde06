"""Parallelism helpers of the port: so far the TP-divisibility padding."""
