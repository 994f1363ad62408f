"""The port's LM substrate: the dense and MoE decoder families (config,
layers, moe, transformer stack, lm)."""
