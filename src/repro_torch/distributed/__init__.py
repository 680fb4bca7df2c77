"""Multi-rank plumbing of the port (counterpart of ``repro/distributed``).

``compat.py`` starts and stops the ``torch.distributed`` process group of
this rank. ``sharding.py`` holds the reference's sharding rules (a spec a
parameter, the batch, the decode cache and the activations) and
``local_block``, which cuts a rank's block of a whole tensor by its spec.
``context.py`` holds the ambient mesh that model code reads, with the
size of the whole batch that the ranks hold blocks of: under it the MoE
layer runs expert parallelism (``models/moe.py``). The mesh over the
ranks is ``repro_torch.launch.mesh``; the pod-scale ANNS steps that run
on it are in ``repro_torch.core.distributed``.
"""
