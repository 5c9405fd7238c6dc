"""Multi-device halo exchange on a single-controller mesh.

Counterparts of ``stencil_tpu/parallel``: the mesh and its ``ppermute``
(``mesh.py``), the communication audit (``comm_audit.py``), the sharded
eager stencil of methods ``sharded``/``sharded_noverlap`` (``halo.py``) and
the per-rank kernel stencil of method ``sharded_pallas``
(``sharded_kernel.py``) and the in-kernel exchange of method ``rma``
(``rma.py``, one cooperative launch per run).
"""
