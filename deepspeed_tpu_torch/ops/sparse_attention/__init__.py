"""Block-sparse attention: the JAX package's ``ops/sparse_attention`` exports."""
from .sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from .sparse_self_attention import SparseSelfAttention, sparse_attention  # noqa: F401
