"""Benchmarks of the port, each the counterpart of one in ``benchmarks/``
(``batched_read``: the row-slab engines of one replica)."""
