"""Graph aggregation split over shards of the node range.

Port of ``sldm_gnn_tpu/parallel/`` as far as one card needs it: the host
planners of the halo exchange (:mod:`.halo`), the per-shard fused SAGE
layers that take a received halo table (:mod:`.halo_fused`), and
:func:`.halo_model.shard_node_array`. The exchange itself, the sum of the
parameter gradients across shards (both on ``torch.distributed``), the
halo classifier and its step functions, ``mesh``, ``data_parallel``,
``edge_partition``, ``streamed`` and ``sampled_ep`` are not ported yet.
"""
