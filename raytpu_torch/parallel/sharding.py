"""Sharding rules: the port of :mod:`raytpu.parallel.sharding`.

In the JAX package "preparing" a model is giving every leaf of its
parameter pytree a ``PartitionSpec``, and XLA inserts the collectives.
Here a model's parameters are a ``state_dict``: the same ordered table of
(name regex → template) gives each tensor a :class:`PartitionSpec`, and
:func:`shard_params` makes each a ``DTensor`` over the mesh's
``DeviceMesh`` (``Shard(d)`` on each mesh dim a tensor dim is split
over, ``Replicate()`` on the others). There is no ``shard_map`` here:
the placements are read by the code that runs on them (Mixtral's experts
over ``ep``, :func:`raytpu_torch.models.mixtral.shard_experts`).

The port's table is the JAX table written for the port's names and
layouts: the port's ``Linear`` stores ``weight [out, in]`` where Flax
stores ``kernel [in, out]``, so each rule for a product matches
``weight`` with the JAX template reversed; embeddings (``[vocab,
embed]``), biases, norms and the stacked experts (``[E, D, F]``) keep
the JAX layout and template. The port's stacks are per layer
(``layers.{i}.``), so there is no scan dim to right-align over, but the
alignment is kept for tensors that have one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from raytpu_torch.parallel.mesh import AbstractMesh, PartitionSpec

P = PartitionSpec
Axis = Union[str, Tuple[str, ...], None]


@dataclass
class ShardingRules:
    """Ordered (parameter-name regex → PartitionSpec template) table.

    The first matching rule wins; a template entry names mesh axes (or
    None = replicated on that dim). Axes absent from the mesh, or of
    size 1, are dropped, so one rule table serves dp-only, fsdp,
    fsdp+tp, ... meshes unchanged.
    """

    rules: Sequence[Tuple[str, Tuple[Axis, ...]]] = field(default_factory=tuple)

    def spec_for(self, path: str, ndim: int, mesh: AbstractMesh) -> P:
        for pattern, template in self.rules:
            if re.search(pattern, path):
                return _drop_missing(template, mesh, ndim)
        return P()  # replicate by default

    def sharding_for(self, path: str, ndim: int, mesh: AbstractMesh) -> list:
        """The DTensor placements of the parameter: one per mesh dim."""
        return placements(self.spec_for(path, ndim, mesh), mesh)


def _drop_missing(template: Tuple[Axis, ...], mesh: AbstractMesh,
                  ndim: int) -> P:
    """Right-align the template to the tensor's trailing dims: a stack of
    layers prepends a layer axis, and the rule still applies to the
    per-layer trailing shape. Extra leading dims replicate."""
    template = template[-ndim:] if len(template) > ndim else template
    out: list = [None] * (ndim - len(template))
    for entry in template:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in mesh.axis_names
                         and mesh.shape[a] > 1)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(entry if entry in mesh.axis_names
                       and mesh.shape[entry] > 1 else None)
    return P(*out)


def placements(spec: P, mesh: AbstractMesh) -> list:
    """``spec`` as DTensor placements: ``Shard(d)`` on the mesh dims that
    tensor dim ``d`` is split over, ``Replicate()`` on the others. A dim
    split over several axes takes them in mesh order (major first), as
    DTensor reads them."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim}'s axes are not in the "
                             f"mesh's order {mesh.axis_names}")
        for i in order:
            out[i] = Shard(dim)
    return out


# Megatron-style transformer table, for the port's names: column-parallel
# weights shard the output dim on tp, row-parallel ones the input dim;
# everything also FSDP-shards its largest non-tp dim. Each product's
# template is the JAX rule's reversed (weight [out, in]).
TRANSFORMER_RULES = ShardingRules(rules=(
    # embeddings: [vocab, embed] — shard vocab on tp, embed on fsdp. Flax
    # names an Embed's leaf "embedding", so the JAX table's first rule
    # also takes GPT-2's wpe; the port's names it.
    (r"(wte|wpe|embed_tokens|embedding|token_embed)", ("tp", "fsdp")),
    (r"pos_embed", (None, "fsdp")),
    # attention qkv (column-parallel): weight [heads*head_dim, embed]
    (r"(attn|attention).*(q_proj|k_proj|v_proj|qkv|c_attn).*weight",
     ("tp", "fsdp")),
    # attention output (row-parallel): weight [embed, heads*head_dim]
    (r"(attn|attention).*(o_proj|out_proj|c_proj).*weight", ("fsdp", "tp")),
    # MoE experts (leading experts dim shards over ep): wi/wg [E, embed,
    # ff] column-style, wo [E, ff, embed] row-style; router replicated.
    (r"(moe|experts).*\bwo$", ("ep", "tp", "fsdp")),
    (r"(moe|experts).*\bw[ig]$", ("ep", "fsdp", "tp")),
    (r"(moe|experts).*router", (None, None)),
    # mlp up (column): weight [ff, embed]
    (r"(mlp|ffn).*(up_proj|gate_proj|c_fc|fc_in|wi).*weight",
     ("tp", "fsdp")),
    # mlp down (row): weight [embed, ff]
    (r"(mlp|ffn).*(down_proj|c_proj|fc_out|wo).*weight", ("fsdp", "tp")),
    # biases on tp-split outputs
    (r"(q_proj|k_proj|v_proj|qkv|c_attn|up_proj|gate_proj|c_fc|wi).*bias",
     ("tp",)),
    # norms / scalars replicated
    (r"(ln|norm|scale)", (None,)),
    # lm head: weight [vocab, embed]
    (r"(lm_head|output_proj)", ("tp", "fsdp")),
    # fallback: FSDP-shard the input dim of big matrices
    (r"weight$", ("tp", "fsdp")),
))


def tree_shardings(state: Dict[str, Any], mesh: AbstractMesh,
                   rules: Optional[ShardingRules] = None) -> Dict[str, list]:
    """Each tensor's DTensor placements, by name (the JAX package's
    pytree of ``NamedSharding`` s)."""
    rules = rules or TRANSFORMER_RULES
    return {name: rules.sharding_for(name, getattr(t, "ndim", 0), mesh)
            for name, t in state.items()}


def shard_params(state: Dict[str, Any], mesh,
                 rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """Place a ``state_dict`` onto the mesh (the ``prepare_model`` moment):
    a state dict of ``DTensor`` s placed by the rules. A collective of the
    mesh's ranks: every rank calls it with the same tensors."""
    from torch.distributed.tensor import distribute_tensor

    shardings = tree_shardings(state, mesh, rules)
    return {name: distribute_tensor(t.to(mesh.device), mesh.device_mesh,
                                    shardings[name])
            for name, t in state.items()}


def shard_batch(batch, mesh, axes: Tuple[str, ...] = ("dp", "fsdp")):
    """Shard the leading (batch) dim over the data axes, and — when an `sp`
    axis exists — the second (sequence) dim over it (context
    parallelism). ``batch``: a tensor or a dict of them."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    present = tuple(a for a in axes if a in mesh.axis_names
                    and mesh.shape[a] > 1)
    batch_axis: Axis = present if len(present) > 1 else (
        present[0] if present else None)

    def spec(leaf) -> P:
        ndim = getattr(leaf, "ndim", 0)
        if ndim == 0:
            return P()
        entries = [batch_axis]
        if ndim >= 2 and "sp" in mesh.axis_names and mesh.shape["sp"] > 1:
            entries.append("sp")
        while len(entries) < ndim:
            entries.append(None)
        return P(*entries)

    def place(leaf):
        return distribute_tensor(leaf.to(mesh.device), mesh.device_mesh,
                                 placements(spec(leaf), mesh))

    if isinstance(batch, torch.Tensor):
        return place(batch)
    return {name: place(leaf) for name, leaf in batch.items()}


def logical_sharding(mesh: AbstractMesh, *axes: Axis) -> list:
    return placements(_drop_missing(tuple(axes), mesh, len(axes)), mesh)
