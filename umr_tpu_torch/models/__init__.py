from .discriminator import Discriminator  # noqa: F401
from .lpips import LPIPSAlex  # noqa: F401
from .mesh_net import MeshNet, MeshNetS1, init_weights, symmetrize  # noqa: F401
