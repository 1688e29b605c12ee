"""Pipeline parallelism as a stage loop over the ``pp`` axis: the port of
:mod:`raytpu.parallel.pipeline`.

Every stage is one rank's shard of the layer stack; activations hop
stages by :func:`~raytpu_torch.collective.mesh_ops.ppermute`, and the
schedule is the GPipe fill and drain, ``n_micro + n - 1`` ticks. What
stands in for ``shard_map`` (and for the JAX ``fori_loop``) is
:func:`~raytpu_torch.collective.mesh_ops.group_call` around a Python
loop, one process a stage. Every stage runs every tick, masked with
``torch.where`` by its index as the JAX program is, so every rank builds
the same graph and the backward's collectives meet. Differentiable, so
training backprops through the pipeline transfer.
"""

from __future__ import annotations

from typing import Callable

import torch

from raytpu_torch.collective import mesh_ops
from raytpu_torch.parallel.mesh import Mesh, PartitionSpec as P


def pipeline_stage_loop(stage_fn: Callable, stage_params, microbatches,
                        *, axis_name: str = "pp"):
    """Run a GPipe-style pipeline inside ``group_call``.

    stage_fn(params, x) -> y: ONE stage's computation (this rank's shard);
      its output is the next stage's input, of the same shape and type.
    stage_params: this rank's stage parameters.
    microbatches: [n_micro, ...] — the full input, present on stage 0
      (other stages ignore their copy).

    Returns [n_micro, ...] outputs, valid on the LAST stage (zeros
    elsewhere) — allreduce or ppermute afterwards if other stages need
    them. Schedule: n_micro + n_stages - 1 ticks (fill + steady + drain).
    """
    n = mesh_ops.axis_size(axis_name)
    idx = mesh_ops.axis_index(axis_name)
    dev = microbatches.device
    first = torch.tensor(idx == 0, device=dev)
    last = torch.tensor(idx == n - 1, device=dev)
    n_micro = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0])  # what stage > 0 takes first
    outputs = []
    perm = [(i, (i + 1) % n) for i in range(n)]
    ticks = n_micro + n - 1
    for t in range(ticks):
        # Stage 0 injects microbatch t while t < n_micro, else zeros.
        mb = microbatches[min(t, n_micro - 1)]
        inject = 1.0 if t < n_micro else 0.0
        x = torch.where(first, mb * inject, state)
        y = stage_fn(stage_params, x)
        # Last stage emits output for microbatch t - (n - 1).
        if t >= n - 1:
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        if t + 1 < ticks:  # the last tick's hand-off would go unread
            # Hand activations to the next stage (ring closes drain to
            # fill).
            state = mesh_ops.ppermute(y, axis_name, perm)
    return torch.stack(outputs)


def _body(stage_fn, axis_name, stage_params, microbatches):
    stage_params = mesh_ops._tree_map(lambda _, x: x.squeeze(0), P(),
                                      stage_params)
    out = pipeline_stage_loop(stage_fn, stage_params, microbatches,
                              axis_name=axis_name)
    # Everyone needs the result: sum over stages (only last is nonzero).
    return mesh_ops.allreduce(out, axis_name)


def pipelined_apply(stage_fn: Callable, all_stage_params, batch, mesh: Mesh,
                    *, n_micro: int, axis_name: str = "pp"):
    """Pipeline over the mesh: params' leading dim = stage, batch is
    global (the same on every rank).

    all_stage_params: a tree (dicts, lists) whose leaves have leading
      dim n_stages (sharded over `axis_name`).
    batch: [B, ...] — split into n_micro microbatches.
    Returns outputs [B, ...] from the last stage, on every rank.
    """
    b = batch.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = batch.reshape((n_micro, b // n_micro) + tuple(batch.shape[1:]))

    def body(stage_params, microbatches):
        return _body(stage_fn, axis_name, stage_params, microbatches)

    out = mesh_ops.group_call(mesh, body, all_stage_params, mb,
                              in_specs=(P(axis_name), P()), out_specs=P())
    return out.reshape((b,) + tuple(out.shape[2:]))
