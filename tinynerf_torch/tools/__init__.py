"""Command-line tools of the port: ``python -m tinynerf_torch.tools.<name>``."""
