"""LM substrate of the port (PyTorch): configs' schema, layers, GQA
attention, blocks and the decoder LM's serving half; ``convert`` carries
the reference's weights across."""
