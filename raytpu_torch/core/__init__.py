"""raytpu_torch.core: the port's copies of what it needs of
``raytpu.core``: the error names its worker-process layer
(:mod:`raytpu_torch.runtime`) raises (:mod:`~raytpu_torch.core.errors`)."""
