"""raytpu_torch.core: the port's copies of what it needs of
``raytpu.core``: the error names its worker-process layer
(:mod:`raytpu_torch.runtime`) raises (:mod:`~raytpu_torch.core.errors`),
the ids (:mod:`~raytpu_torch.core.ids`), the fixed-point resource sets
(:mod:`~raytpu_torch.core.resources`), and the host's cards, counted
without CUDA (:mod:`~raytpu_torch.core.topology`)."""
