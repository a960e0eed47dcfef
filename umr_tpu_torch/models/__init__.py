from .mesh_net import MeshNet, init_weights, symmetrize  # noqa: F401
