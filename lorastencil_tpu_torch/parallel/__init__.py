"""Domain decomposition of the engines over a mesh of shards
(``domain.py``) and multi-process meshes (``multihost.py``)."""
