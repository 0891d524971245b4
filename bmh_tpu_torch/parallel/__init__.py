"""Multi-process block stripes on torch.distributed (distributed.py)."""
