"""Training: the step factory and the fault-tolerant loop."""
from repro_torch.train.loop import TrainLoop
from repro_torch.train.step import make_train_step

__all__ = ["make_train_step", "TrainLoop"]
