"""Doc-sharded execution over a mesh of torch devices: the mesh and its
spec parser (``mesh.py``), the sharded routes (``query.py``) and a dry run
of every path (``dryrun.py``)."""
