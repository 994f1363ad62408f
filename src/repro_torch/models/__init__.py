"""The port's LM substrate: the dense decoder family (config, layers,
transformer stack, lm)."""
