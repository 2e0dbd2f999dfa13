"""Tensor-parallel serving over a (data, model) mesh of torch.distributed ranks."""
