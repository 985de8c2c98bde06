"""LM substrate of the port (PyTorch): configs' schema, layers, GQA and MLA
attention, MoE, the SSD block, the four block kinds and the decoder LM's
serving half; ``convert`` carries the reference's weights across."""
