from .matrices import (LinearSystem, generate_dense_set, generate_sparse_set,
                       pad_batch, pad_system, randsvd_dense, sparse_spd)
from .tokens import TokenPipeline

__all__ = ["LinearSystem", "TokenPipeline", "generate_dense_set",
           "generate_sparse_set", "pad_batch", "pad_system", "randsvd_dense",
           "sparse_spd"]
