"""paddle.distributed.fleet for the training slice: the strategy and the
single-device train step."""
from .compiler import CompiledTrainStep, compile_train_step
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "CompiledTrainStep", "compile_train_step"]
