"""Training of the port's LM: the optimizer and the train step."""
