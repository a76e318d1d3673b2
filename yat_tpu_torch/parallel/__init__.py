"""Training across processes: the data axes of ``mesh_shape``
(``mesh.py``) and the coordination of the processes (``multihost.py``)."""
