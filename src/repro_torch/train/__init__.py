"""repro_torch.train: the train step (:mod:`.train_step`), checkpoints
(:mod:`.checkpoint`) and the fleet's fault-tolerance logic (:mod:`.fault`)."""

from . import fault  # noqa: F401
