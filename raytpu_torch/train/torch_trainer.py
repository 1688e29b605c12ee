"""TorchTrainer, ``prepare_model`` and ``prepare_data_loader``, the port
of :mod:`raytpu.train.torch_trainer`.

In the JAX package ``TorchTrainer`` runs torch loops on a gloo group
beside its JAX trainer; in the port every gang is a ``torch.distributed``
group (NCCL on the card, gloo on the CPU), so ``TorchTrainer`` is
:class:`~raytpu_torch.train.trainer.DataParallelTrainer` itself.
``prepare_model`` does the reference's device move, which the JAX package
skips for want of a card, before the DDP wrap.
"""

from __future__ import annotations

from raytpu_torch.train.session import get_context
from raytpu_torch.train.trainer import DataParallelTrainer

TorchTrainer = DataParallelTrainer


def prepare_model(model):
    """Move ``model`` to the worker's device (``cuda:<local rank>`` or the
    CPU; outside a session it stays where it is) and wrap it in DDP when
    the gang's process group has more than one rank (reference:
    ``ray.train.torch.prepare_model``); on the card DDP gets
    ``device_ids=[local_rank]``."""
    import torch.distributed as dist

    dev = get_context().device
    if dev is not None:
        model = model.to(dev)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        if dev is not None and dev.type == "cuda":
            return DistributedDataParallel(model, device_ids=[dev.index])
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(data_loader):
    """Shard a DataLoader across the gang with a DistributedSampler
    (reference: ``ray.train.torch.prepare_data_loader``). The incoming
    loader's shuffle intent is preserved (an eval loader built with
    ``shuffle=False`` stays ordered). Pass-through cases: world size 1,
    non-map-style datasets, and ``batch_sampler`` loaders (their
    ``batch_size`` is None — rebuilding would disable batching).

    For shuffling loaders, call ``loader.sampler.set_epoch(epoch)`` at
    each epoch start (standard DistributedSampler contract) or every
    epoch reuses one permutation."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import (DataLoader, DistributedSampler,
                                  RandomSampler)

    ds = data_loader.dataset
    if not hasattr(ds, "__len__"):
        _warn_unsharded("an iterable-style dataset (no __len__)")
        return data_loader
    if data_loader.batch_size is None:
        _warn_unsharded("a batch_sampler loader (batch_size is None)")
        return data_loader
    from torch.utils.data import SequentialSampler

    old_sampler = data_loader.sampler
    shuffle = isinstance(old_sampler, RandomSampler)
    if not shuffle and not isinstance(old_sampler, SequentialSampler):
        import warnings

        warnings.warn(
            f"prepare_data_loader: replacing custom sampler "
            f"{type(old_sampler).__name__} with an unshuffled "
            f"DistributedSampler — its sampling semantics (weighting, "
            f"ordering) are LOST. Apply the custom logic inside the "
            f"dataset, or shard manually by rank.", UserWarning,
            stacklevel=2)
    sampler = DistributedSampler(ds, num_replicas=dist.get_world_size(),
                                 rank=dist.get_rank(), shuffle=shuffle)
    num_workers = getattr(data_loader, "num_workers", 0)
    kwargs = dict(
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=num_workers,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
        pin_memory=getattr(data_loader, "pin_memory", False),
        worker_init_fn=getattr(data_loader, "worker_init_fn", None),
        generator=getattr(data_loader, "generator", None),
        timeout=getattr(data_loader, "timeout", 0),
    )
    if num_workers > 0:
        # Only legal to pass with worker processes (DataLoader raises
        # on prefetch_factor/persistent_workers at num_workers=0).
        kwargs["persistent_workers"] = getattr(
            data_loader, "persistent_workers", False)
        pf = getattr(data_loader, "prefetch_factor", None)
        if pf is not None:
            kwargs["prefetch_factor"] = pf
        kwargs["multiprocessing_context"] = getattr(
            data_loader, "multiprocessing_context", None)
    return DataLoader(ds, **kwargs)


def _warn_unsharded(why: str) -> None:
    import warnings

    import torch.distributed as dist

    warnings.warn(
        f"prepare_data_loader: cannot shard {why} at world size "
        f"{dist.get_world_size()} — EVERY worker will iterate the FULL "
        f"dataset (duplicate epochs). Shard inside the dataset itself "
        f"(e.g. by rank) or switch to a map-style dataset with a "
        f"batch_size loader.", UserWarning, stacklevel=3)
