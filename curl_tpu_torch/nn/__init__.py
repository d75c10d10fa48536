from .module import (  # noqa: F401
    GELU,
    Attention,
    Embedding,
    LayerNorm,
    Linear,
    Module,
    Sequential,
    Softmax,
    layernorm,
)
