"""Entry points of the port's LM substrate: ``python -m repro_torch.launch.serve``."""
