"""Model and shape configurations: the JAX package's ``configs``, copied as data."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable  # noqa: F401
from repro_torch.configs.registry import ARCHS, get  # noqa: F401
