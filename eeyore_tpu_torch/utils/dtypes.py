import torch


def default_float():
    """The default floating dtype: PyTorch's (``torch.get_default_dtype()``),
    float32 unless the caller set float64 (the CPU parity runs do)."""
    return torch.get_default_dtype()
