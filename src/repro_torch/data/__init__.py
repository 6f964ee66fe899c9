from repro_torch.data import tokenizer
from repro_torch.data.pipeline import ArithmeticTask, Batch, TaskConfig

__all__ = ["ArithmeticTask", "Batch", "TaskConfig", "tokenizer"]
