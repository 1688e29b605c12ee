"""raytpu_torch.cluster: the port's copies of what its serving plane needs
of ``raytpu.cluster`` — the tuning constants of the KV handoff
(:mod:`~raytpu_torch.cluster.constants`) and the process-wide transfer
window (:mod:`~raytpu_torch.cluster.transfer`). The runtime itself (head,
nodes, the object plane) is not ported."""
