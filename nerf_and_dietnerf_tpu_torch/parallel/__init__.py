"""Data parallelism over a ``torch.distributed`` process group."""
