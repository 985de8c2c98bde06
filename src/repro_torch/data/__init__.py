"""The port's training data: the synthetic corpus and the HR-routed
pipeline over its document index."""
