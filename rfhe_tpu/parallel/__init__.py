"""Mesh / multi-host helpers (SURVEY §2.6: the scale-out layer the reference
lacks).  Collectives live in transform/distributed.py; this module owns
mesh construction and DCN multi-host initialization."""
from .mesh import make_mesh, make_mesh_2d, init_multihost  # noqa: F401
