"""The fault-tolerant training loop of the LM substrate (port of
``repro.train``)."""
from repro_torch.train.loop import LoopConfig, make_train_step, train
