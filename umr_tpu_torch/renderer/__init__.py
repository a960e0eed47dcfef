from .soft_renderer import SoftRenderer, apply_lighting, surface_normals  # noqa: F401
