"""raytpu_torch.scripts: the command line (``python -m raytpu_torch``)."""
