from repro_torch.data import tokenizer

__all__ = ["tokenizer"]
