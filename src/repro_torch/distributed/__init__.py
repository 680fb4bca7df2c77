"""Multi-rank plumbing of the port (counterpart of ``repro/distributed``).

``compat.py`` starts and stops the ``torch.distributed`` process group of
this rank. The mesh over the ranks is ``repro_torch.launch.mesh``; the
steps that run on it are in ``repro_torch.core.distributed``.
"""
